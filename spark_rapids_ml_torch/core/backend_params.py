#
# Param-mapping layer between the pyspark.ml-style API params and the port's
# backend kernel params: the counterpart of the JAX package's
# core/backend_params.py (_TpuClass/_TpuParams), itself the structural
# equivalent of the reference's _CumlClass/_CumlParams
# (reference python/src/spark_rapids_ml/params.py:162-487).
#
# Differences from the JAX package, on purpose:
#   * no CPU fallback twin: a Spark param or value the backend cannot honor makes
#     fit() raise, it never switches to another implementation quietly;
#   * `device` ("cuda" or "cpu") is a constructor keyword beside num_workers and
#     float32_inputs; unset, it comes from the port's config key `device`.
#

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import torch

from .params import Param, Params, TypeConverters


class HasFeaturesCols(Params):
    """Mirror of reference params.py:69-89: multi-column numeric feature input."""

    featuresCols: Param[List[str]] = Param(
        "undefined",
        "featuresCols",
        "features column names for multi-column input.",
        TypeConverters.toListString,
    )

    def getFeaturesCols(self) -> List[str]:
        return self.getOrDefault(self.featuresCols)

    def setFeaturesCols(self, value: List[str]) -> "HasFeaturesCols":
        return self._set(featuresCols=value)  # type: ignore[return-value]


class HasIDCol(Params):
    """Mirror of reference params.py:91-142: a row-id column for algorithms whose
    results are joined back to the input rows. kNN returns these ids; DBSCAN,
    whose output keeps the input's row order, accepts and carries it."""

    idCol: Param[str] = Param(
        "undefined",
        "idCol",
        "id column name; used to identify rows in results that are returned "
        "out of input order.",
        TypeConverters.toString,
    )

    def getIdCol(self) -> str:
        return self.getOrDefault(self.idCol)

    def setIdCol(self, value: str) -> "HasIDCol":
        return self._set(idCol=value)  # type: ignore[return-value]

    def _ensureIdCol(self, df: Any, offset: int = 0) -> Any:
        """`df` with the id column (reference params.py:110-129): when idCol is
        unset it becomes "unique_id_<uid>", and a pandas frame without the
        column gets one numbering its rows from `offset` (a rank's global row
        offset under a process group)."""
        from .dataset import ensure_id_col

        return ensure_id_col(df, self._id_col_name(), offset)

    def _id_col_name(self) -> str:
        """The id column's name; an unset idCol becomes "unique_id_<uid>"."""
        if not self.isDefined(self.idCol):
            self._set(idCol="unique_id_" + self.uid)
        return self.getOrDefault(self.idCol)


def resolve_device(name: Optional[str] = None) -> torch.device:
    """The torch device an entry point runs on: `name`, else the config key
    `device` ("cuda" by default). A CUDA request without a usable card raises:
    the port never carries on on the CPU in its place."""
    from .. import config as _config

    dev = torch.device(name if name is not None else str(_config.get("device")))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or set the config key 'device') to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev


class _TorchClass:
    """Declares the Spark-param ⇄ backend-param correspondence for one estimator
    (counterpart of the JAX package's _TpuClass)."""

    @classmethod
    def _param_mapping(cls) -> Mapping[str, Optional[str]]:
        """Mapping of pyspark.ml param name -> backend kernel param name.

        None  => unsupported: fit() raises if the user sets a non-default value.
        ''    => accepted but ignored by the backend (Spark-API-only param).
        """
        return {}

    @classmethod
    def _param_value_mapping(cls) -> Dict[str, Callable[[Any], Union[None, Any]]]:
        """Mapping of backend param name -> function translating Spark value to backend
        value; return None from the function to indicate an invalid value."""
        return {}

    @classmethod
    def _get_torch_params_default(cls) -> Dict[str, Any]:
        """Default values of the backend kernel params for this algorithm."""
        return {}

    @classmethod
    def _format_params_default(cls) -> Dict[str, Any]:
        """Backend params the saved-model format carries that the port has no
        op for, each at the one value the port computes (core/persistence.py)."""
        return {}


# Spark ParamValidators equivalents: (lo, hi) inclusive bounds, None = unbounded
_PARAM_BOUNDS: Dict[str, Any] = {
    "k": (1, None),
    "maxIter": (0, None),
    "regParam": (0.0, None),
    "elasticNetParam": (0.0, 1.0),
    "tol": (0.0, None),
    "eps": (1e-30, None),
    "min_samples": (1, None),
}


class _TorchParams(Params):
    """Keeps a dict of backend params in sync with the pyspark.ml-style Params
    (counterpart of the JAX package's _TpuParams). Holds:
      * _torch_params: the kernel param dict handed to ops/ fit functions
      * _device: the device name asked for at construction (None = config)
      * float32_inputs: cast inputs to float32 (reference params.py:286-299)."""

    _torch_params: Dict[str, Any]
    _device: Optional[str] = None
    _float32_inputs: bool = True

    # per-estimator overrides/additions merged over _PARAM_BOUNDS
    _PARAM_BOUNDS_EXTRA: Dict[str, Any] = {}

    def __init__(self) -> None:
        super().__init__()
        self._torch_params = {}
        self._unsupported_params: Dict[str, Any] = {}

    @property
    def device(self) -> torch.device:
        """The device fit/transform run on (raises if it is CUDA and there is none)."""
        return resolve_device(self._device)

    def _validate_param_bounds(self) -> None:
        """Raise a clear ValueError when a numeric param is out of its Spark-valid
        range instead of failing deep in a kernel."""
        for name, (lo, hi) in {**_PARAM_BOUNDS, **self._PARAM_BOUNDS_EXTRA}.items():
            if not self.hasParam(name) or not self.isDefined(name):
                continue
            value = self.getOrDefault(name)
            if value is None:
                continue
            if lo is not None and value < lo:
                raise ValueError(f"Param {name}={value} must be >= {lo}.")
            if hi is not None and value > hi:
                raise ValueError(f"Param {name}={value} must be <= {hi}.")

    def _check_supported(self) -> None:
        """Raise for any param or value the backend cannot honor."""
        if self._unsupported_params:
            raise ValueError(
                f"{type(self).__name__}: params {self._unsupported_params} are not "
                "supported by the PyTorch backend."
            )

    def initialize_torch_params(self) -> None:
        """Set the backend param dict to defaults, then sync Spark-side defaults in."""
        assert isinstance(self, _TorchClass)
        self._torch_params = dict(self._get_torch_params_default())
        for spark_name, backend_name in self._param_mapping().items():
            if backend_name and self.hasParam(spark_name) and self.hasDefault(spark_name):
                self._set_torch_value(backend_name, self.getOrDefault(spark_name))

    def _set_params(self, **kwargs: Any) -> "_TorchParams":
        """Set params from either Spark names or backend names, keeping both sides in
        sync (reference params.py:430-487)."""
        assert isinstance(self, _TorchClass)
        mapping = self._param_mapping()
        for k, v in kwargs.items():
            if k == "device":
                self._device = None if v is None else str(v)
            elif k == "float32_inputs":
                self._float32_inputs = bool(v)
            elif self.hasParam(k):
                self._set(**{k: v})
                backend_name = mapping.get(k, "")
                if backend_name is None:
                    self._handle_unsupported(k, v)
                elif backend_name:
                    self._set_torch_value(backend_name, v)
            elif k in self._torch_params:
                # backend-side name; also sync any spark alias
                self._set_torch_value(k, v, translate=False)
                for spark_name, backend_name in mapping.items():
                    if backend_name == k and self.hasParam(spark_name):
                        self._set(**{spark_name: v})
            else:
                raise ValueError(f"Unsupported param '{k}'.")
        return self

    def _handle_unsupported(self, name: str, value: Any) -> None:
        """A Spark param the backend does not support: harmless at its default,
        otherwise recorded so fit() raises."""
        param = self.getParam(name)
        if param in self._defaultParamMap and self._defaultParamMap[param] == value:
            self._unsupported_params.pop(name, None)
        else:
            self._unsupported_params[name] = value

    def _set_torch_value(self, backend_name: str, value: Any, translate: bool = True) -> None:
        assert isinstance(self, _TorchClass)
        value_mapping = self._param_value_mapping()
        if translate and backend_name in value_mapping:
            mapped = value_mapping[backend_name](value)
            if mapped is None:
                self._unsupported_params[backend_name] = value
                return
            value = mapped
        self._unsupported_params.pop(backend_name, None)
        self._torch_params[backend_name] = value

    def _copyValues(self, to: Params, extra: Optional[Dict[Param, Any]] = None) -> Params:
        to = super()._copyValues(to, extra)
        if isinstance(to, _TorchParams):
            to._torch_params = dict(self._torch_params)
            to._device = self._device
            to._float32_inputs = self._float32_inputs
            to._unsupported_params = dict(self._unsupported_params)
            if extra and isinstance(to, _TorchClass):
                mapping = to._param_mapping()
                for param, value in extra.items():
                    backend_name = mapping.get(param.name, "")
                    if backend_name:
                        to._set_torch_value(backend_name, value)
                    elif backend_name is None:
                        to._handle_unsupported(param.name, value)
        return to

    def _get_input_columns(self) -> tuple:
        """Resolve the (single_col, multi_cols) input spec from whichever of
        inputCol/inputCols/featuresCol/featuresCols is set
        (reference params.py:489-530)."""
        for name, multi in (
            ("inputCols", True), ("inputCol", False),
            ("featuresCols", True), ("featuresCol", False),
        ):
            if self.hasParam(name) and self.isDefined(name):
                value = self.getOrDefault(name)
                return (None, value) if multi else (value, None)
        raise ValueError("Please set inputCol(s) or featuresCol(s)")
