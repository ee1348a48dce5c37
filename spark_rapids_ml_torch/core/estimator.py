#
# Estimator/Model framework of the PyTorch port: the in-core, one-device subset of
# the JAX package's core/estimator.py (itself the structural equivalent of
# _CumlCaller/_CumlEstimator/_CumlModel, reference core.py:435-1967).
#
# fit() extracts host features, stages them on the estimator's device (unpadded:
# parallel/partition.py), and hands FitInputs to the estimator's fit function,
# which returns a dict of model attributes. transform() stages the rows the same
# way and appends the outputs to the input. Supervised estimators
# (_TorchEstimatorSupervised) also extract and stage the label column.
#
# Staging: on the card one preallocated device tensor is filled chunk by chunk
# through the pinned ring of ops/ingest.py (the counterpart of the JAX package's
# jnp.asarray staging: it changes how the bytes travel, not what arrives); on
# the CPU the tensor shares the host array.
#
# Out-of-core dispatch (the JAX package's core/estimator.py:344-366): an
# estimator with a `_streaming_fit` (PCA, KMeans, LinearRegression, both
# random forests) whose design matrix exceeds config.stream_threshold_bytes
# streams its rows through the device in batches (ops/streaming.py) inside one
# device batch-cache scope (ops/device_cache.py), freed at the fit's exit. A
# model whose `_transform_host` takes the block (DBSCAN's above the threshold)
# transforms it out-of-core, and nothing is staged whole.
#
# Across processes (the JAX package's core/estimator.py:203-287 and the
# barrier task body of spark/integration.py:171-356): under a multi-process
# group (parallel/bootstrap.py, parallel/partitioner.py) each rank calls fit()
# with its own partition of the rows, and every rank returns the same model.
# One all-gather of every rank's (rows, cols) gives the global
# PartitionDescriptor; only a global total of 0 rows raises "Fit input is
# empty", and a rank with no rows adds zeros and takes part in every
# collective. The streamed-or-in-core choice is collective: all ranks stream
# when any rank's X exceeds its threshold (one all-reduce MAX), so that no two
# ranks run different collectives. No process gathers the global X, and a
# group never falls back to a single-process fit. A model's transform is each
# rank's own, with no collective, but for DBSCAN's (`_collective_transform`),
# which clusters every rank's rows: an empty frame is then a rank's empty
# partition, which joins the collectives.
#
# Persistence: `write`/`save`/`read`/`load` on estimators and models (the
# mixin core/persistence.py::Persistable), in the JAX package's directory
# format; `_TorchModel._from_row` rebuilds a model from its saved attributes.
#
# Not ported: the Spark barrier/collect planes, fitMultiple, the observability
# run scopes and the reliability ladder. The ladder's device-to-CPU rung in
# particular is left out on purpose: a fit that fails on the card raises, it is
# never re-run somewhere else.
#

from __future__ import annotations

from abc import abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import config as _config
from ..ops import ingest
from ..ops.device_cache import batch_cache
from ..ops.streaming import in_flight_bytes
from ..parallel.partition import PartitionDescriptor, pad_rows
from ..parallel.partitioner import Partitioner, active_partitioner, resolve_batch_rows_per_process
from ..utils import get_logger, span
from .backend_params import _TorchClass, _TorchParams
from .dataset import (
    FeatureData,
    append_output_columns,
    empty_partition,
    ensure_dtype,
    extract_feature_data,
)
from .params import ParamMap
from .persistence import Persistable


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
    # the ranks of the fit (parallel/partitioner.py): the ops add their
    # statistics across them; a single process adds nothing
    partitioner: Optional[Partitioner] = None


# type of the value returned by _get_torch_fit_func
FitFunc = Callable[[FitInputs], Dict[str, Any]]


def stage(X: np.ndarray, device: torch.device, ring: Optional[ingest.PinnedRing] = None
          ) -> torch.Tensor:
    """The host array on `device`. On the card: one device tensor, filled
    through a pinned ring (ops/ingest.py). On the CPU there is no copy, unless
    the array is strided or read-only (as arrays handed over by JAX are),
    because the tensor would alias it."""
    if device.type == "cpu":
        return torch.from_numpy(np.require(X, requirements=["C", "W"]))
    X = np.ascontiguousarray(X)
    dtype = ingest.host_tensor(np.empty(0, X.dtype)).dtype
    return ingest.upload(X, device, dtype, ring or ingest.PinnedRing(device))


class _TorchEstimator(_TorchClass, _TorchParams, Persistable):
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

    def _pre_process_data(self, dataset: Any, part: Optional[Partitioner] = None) -> FeatureData:
        input_col, input_cols = self._get_input_columns()
        label_col = self.getOrDefault("labelCol") if self._use_label() else None
        weight_col = self.getOrDefault("weightCol") if self._use_sample_weight() else None
        empty = empty_partition(dataset, part is not None and part.is_multiprocess,
                                np.float32 if self._float32_inputs else np.float64,
                                label=label_col is not None, weight=weight_col is not None)
        if empty is not None:
            return empty
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

    def _build_fit_inputs(self, fd: FeatureData, device: torch.device,
                          desc: PartitionDescriptor, part: Partitioner) -> FitInputs:
        X = ensure_dtype(fd.features, float32=self._float32_inputs)
        # one device: no padding, so X and the weights come back uncopied
        X, unit, (sw,) = pad_rows(X, 1, fd.weight)
        row_weight = unit if sw is None else sw.astype(X.dtype)
        with span("stage"):
            ring = ingest.PinnedRing(device) if device.type == "cuda" else None
            features = stage(X, device, ring)
            row_weight = stage(row_weight, device, ring)
            label = None if fd.label is None else stage(fd.label.astype(X.dtype), device, ring)
        return FitInputs(
            features=features,
            row_weight=row_weight,
            desc=desc,
            device=device,
            unit_weight=sw is None,
            label=label,
            partitioner=part,
        )

    @abstractmethod
    def _create_pyspark_model(self, attrs: Dict[str, Any]) -> "_TorchModel":
        """Build the model object from fit attributes (reference core.py:1084)."""

    def _streams(self, fd: FeatureData, device: torch.device) -> bool:
        """Whether this fit takes the streamed out-of-core path: the estimator
        has one and its design matrix exceeds the stream threshold."""
        if not hasattr(self, "_streaming_fit"):
            return False
        threshold = _config.stream_threshold_bytes(device)
        feature_bytes = fd.n_rows * fd.n_cols * (4 if self._float32_inputs else 8)
        return bool(threshold) and feature_bytes > threshold

    def fit(self, dataset: Any, params: Optional[ParamMap] = None) -> "_TorchModel":
        if params is not None:
            if not isinstance(params, dict):
                raise TypeError(f"params must be a param map, got {type(params)}")
            return self.copy(params).fit(dataset)
        self._validate_param_bounds()
        self._check_supported()
        device = self.device
        part = active_partitioner()
        with span("extract"):
            fd = self._pre_process_data(dataset, part)
        desc = part.descriptor(fd.n_rows, fd.n_cols)
        if desc.m == 0:
            raise RuntimeError("Fit input is empty.")
        if fd.n_rows == 0:  # this rank's empty partition, at the group's width
            fd.features = fd.features.reshape(0, desc.n)
        if part.any(self._streams(fd, device)):
            batch_rows = resolve_batch_rows_per_process(part)
            itemsize = 4 if self._float32_inputs else 8
            in_flight = in_flight_bytes(batch_rows, desc.n, itemsize, 2)
            with batch_cache(device, in_flight):
                attrs = self._streaming_fit(fd, device, desc, part)
        else:
            attrs = self._get_torch_fit_func()(self._build_fit_inputs(fd, device, desc, part))
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


class _TorchModel(_TorchClass, _TorchParams, Persistable):
    """Abstract fitted model (reference _CumlModel, core.py:1356-1754).

    Holds the fit-produced attribute dict; transform() extracts features, runs the
    predict kernel on the model's device, and appends output columns preserving
    the input dataset flavor."""

    # whether transform() is a collective under a process group (DBSCAN's,
    # which clusters every rank's rows): an empty frame is then this rank's
    # empty partition, which still joins the collectives
    _collective_transform = False

    def __init__(self, **model_attributes: Any) -> None:
        super().__init__()
        self._model_attributes: Dict[str, Any] = model_attributes
        self._has_training_summary = False
        self.logger = get_logger(self.__class__)

    def get_model_attributes(self) -> Dict[str, Any]:
        return self._model_attributes

    @classmethod
    def _from_row(cls, attrs: Dict[str, Any]) -> "_TorchModel":
        """Rebuild from an attribute dict of numpy arrays and scalars
        (reference core.py:1389-1396)."""
        return cls(**attrs)

    def _transform_host(self, X: np.ndarray, device: torch.device
                        ) -> Optional[Dict[str, np.ndarray]]:
        """The outputs of a transform that keeps the host block X on the host
        (a streamed, out-of-core transform), or None: X is then staged on the
        device whole and `_transform_arrays` runs."""
        return None

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
        collective = self._collective_transform and active_partitioner().is_multiprocess
        with span("extract"):
            fd = empty_partition(dataset, collective,
                                 np.float32 if self._float32_inputs else np.float64)
            if fd is None:
                fd = extract_feature_data(
                    dataset, input_col=input_col, input_cols=input_cols,
                    float32=self._float32_inputs,
                )
            X = ensure_dtype(fd.features, float32=self._float32_inputs)
        outputs = self._transform_host(X, device)
        if outputs is None:
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
