#
# Estimator/Model framework of the PyTorch port: the in-core, one-device subset of
# the JAX package's core/estimator.py (itself the structural equivalent of
# _CumlCaller/_CumlEstimator/_CumlModel, reference core.py:435-1967).
#
# fit() extracts host features, stages them on the estimator's device in one copy
# (unpadded: parallel/partition.py), and hands FitInputs to the estimator's fit
# function, which returns a dict of model attributes. transform() stages the rows
# the same way and appends the outputs to the input. Supervised estimators
# (_TorchEstimatorSupervised) also extract and stage the label column.
#
# Not ported: the Spark barrier/collect planes, the streamed out-of-core dispatch,
# fitMultiple, the observability run scopes and the reliability ladder. The
# ladder's device-to-CPU rung in particular is left out on purpose: a fit that
# fails on the card raises, it is never re-run somewhere else.
#

from __future__ import annotations

import warnings
from abc import abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..parallel.partition import PartitionDescriptor, pad_rows
from ..utils import get_logger, span
from .backend_params import _TorchClass, _TorchParams
from .dataset import FeatureData, append_output_columns, ensure_dtype, extract_feature_data
from .params import ParamMap


@dataclass
class FitInputs:
    """Everything a fit function sees (reference core.py:604-635)."""

    features: torch.Tensor  # (n, d) on `device`, unpadded
    row_weight: torch.Tensor  # (n,) sample weights, 1.0 when there are none
    desc: PartitionDescriptor
    device: torch.device
    # True when there is no weightCol: kernels then take their unit-weight forms,
    # which read no weight vector
    unit_weight: bool = True
    label: Optional[torch.Tensor] = None  # (n,) in the features' dtype, supervised fits


# type of the value returned by _get_torch_fit_func
FitFunc = Callable[[FitInputs], Dict[str, Any]]


def stage(X: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host-to-device copy of a host array. On the CPU there is no copy,
    unless the array is strided or read-only (as arrays handed over by JAX
    are), because the tensor would alias it."""
    if device.type == "cpu":
        return torch.from_numpy(np.require(X, requirements=["C", "W"]))
    with warnings.catch_warnings():  # the copy to the card never writes to X
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(np.ascontiguousarray(X)).to(device)


class _TorchEstimator(_TorchClass, _TorchParams):
    """Abstract estimator (reference _CumlCaller/_CumlEstimator, core.py:435-1354)."""

    def __init__(self) -> None:
        super().__init__()
        self.logger = get_logger(self.__class__)

    @abstractmethod
    def _get_torch_fit_func(self) -> FitFunc:
        """Return the fit closure (reference core.py:604-635)."""

    def _use_sample_weight(self) -> bool:
        return self.hasParam("weightCol") and self.isDefined("weightCol")

    def _use_label(self) -> bool:
        return False

    def _pre_process_data(self, dataset: Any) -> FeatureData:
        input_col, input_cols = self._get_input_columns()
        label_col = self.getOrDefault("labelCol") if self._use_label() else None
        weight_col = self.getOrDefault("weightCol") if self._use_sample_weight() else None
        fd = extract_feature_data(
            dataset,
            input_col=input_col,
            input_cols=input_cols,
            label_col=label_col,
            weight_col=weight_col,
            float32=self._float32_inputs,
        )
        if label_col is not None and fd.label is None:
            raise ValueError(
                f"{type(self).__name__} needs a label column '{label_col}': fit it "
                "on a DataFrame that holds one"
            )
        return fd

    def _build_fit_inputs(self, fd: FeatureData, device: torch.device) -> FitInputs:
        X = ensure_dtype(fd.features, float32=self._float32_inputs)
        # one device: no padding, so X and the weights come back uncopied
        X, unit, (sw,) = pad_rows(X, 1, fd.weight)
        row_weight = unit if sw is None else sw.astype(X.dtype)
        with span("stage"):
            features = stage(X, device)
            row_weight = stage(row_weight, device)
            label = None if fd.label is None else stage(fd.label.astype(X.dtype), device)
        return FitInputs(
            features=features,
            row_weight=row_weight,
            desc=PartitionDescriptor.build([fd.n_rows], fd.n_cols, padded_m=fd.n_rows),
            device=device,
            unit_weight=sw is None,
            label=label,
        )

    @abstractmethod
    def _create_pyspark_model(self, attrs: Dict[str, Any]) -> "_TorchModel":
        """Build the model object from fit attributes (reference core.py:1084)."""

    def fit(self, dataset: Any, params: Optional[ParamMap] = None) -> "_TorchModel":
        if params is not None:
            if not isinstance(params, dict):
                raise TypeError(f"params must be a param map, got {type(params)}")
            return self.copy(params).fit(dataset)
        self._validate_param_bounds()
        self._check_supported()
        device = self.device
        with span("extract"):
            fd = self._pre_process_data(dataset)
        if fd.n_rows == 0:
            raise RuntimeError("Fit input is empty.")
        attrs = self._get_torch_fit_func()(self._build_fit_inputs(fd, device))
        model = self._create_pyspark_model(attrs)
        # freshly-fit marker: training summaries exist only on fit() results
        model._has_training_summary = True
        self._copyValues(model)  # params, device and float32_inputs
        return model


class _TorchEstimatorSupervised(_TorchEstimator):
    """Supervised estimator: extracts the label column too and stages it beside
    the features (reference _CumlEstimatorSupervised, core.py:1314-1354)."""

    def _use_label(self) -> bool:
        return True


class _TorchModel(_TorchClass, _TorchParams):
    """Abstract fitted model (reference _CumlModel, core.py:1356-1754).

    Holds the fit-produced attribute dict; transform() extracts features, runs the
    predict kernel on the model's device, and appends output columns preserving
    the input dataset flavor."""

    def __init__(self, **model_attributes: Any) -> None:
        super().__init__()
        self._model_attributes: Dict[str, Any] = model_attributes
        self._has_training_summary = False
        self.logger = get_logger(self.__class__)

    def get_model_attributes(self) -> Dict[str, Any]:
        return self._model_attributes

    @abstractmethod
    def _transform_arrays(self, X: torch.Tensor) -> Dict[str, np.ndarray]:
        """Map a staged feature block to named host output arrays (the reference's
        _get_cuml_transform_func closure pair, core.py:1398-1428)."""

    def transform(self, dataset: Any, params: Optional[ParamMap] = None) -> Any:
        if params:
            return self.copy(params).transform(dataset)
        self._validate_param_bounds()
        self._check_supported()
        device = self.device
        input_col, input_cols = self._get_input_columns()
        with span("extract"):
            fd = extract_feature_data(
                dataset, input_col=input_col, input_cols=input_cols,
                float32=self._float32_inputs,
            )
            X = ensure_dtype(fd.features, float32=self._float32_inputs)
        with span("stage"):
            X = stage(X, device)
        with span("compute"):  # the kernel and the copy of its output to the host
            outputs = self._transform_arrays(X)
        with span("output"):
            return append_output_columns(dataset, outputs)


def extract_eval_columns(model: _TorchModel, dataset: Any):
    """Shared plumbing of model.evaluate(): transform the labeled dataset and pull
    (predictions frame, label, prediction, weight) as float64 host arrays. A
    defined weightCol missing from the frame raises, it is never dropped."""
    out = model.transform(dataset)
    label = np.asarray(out[model.getOrDefault("labelCol")], np.float64)
    pred = np.asarray(out[model.getOrDefault("predictionCol")], np.float64)
    weight = None
    if model.hasParam("weightCol") and model.isDefined("weightCol"):
        weight = np.asarray(out[model.getOrDefault("weightCol")], np.float64)
    return out, label, pred, weight
