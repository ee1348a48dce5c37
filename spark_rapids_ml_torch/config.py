#
# Process-wide config for the PyTorch port: the keys this package reads, settable
# programmatically (`set`) or through SRML_TORCH_* environment variables.
#
# Keys:
#   device            (str,  env SRML_TORCH_DEVICE)            "cuda" (default) or
#                     "cpu". Entry points run on the card unless the caller asks
#                     for the CPU here or through an estimator's `device=` keyword.
#   parity_precision  (str,  env SRML_TORCH_PARITY_PRECISION)  "highest" (default):
#                     model-attribute products run in full f32 (no TF32); "high":
#                     the KMeans (Lloyd, assignment), PCA and LinearRegression
#                     kernels take the two-part bf16 split (ops/_precision.py), the
#                     library products stay f32. Another value raises ValueError.
#   fast_math         (bool, env SRML_TORCH_FAST_MATH)         KMeans only: the Lloyd
#                     step's products in one bf16 pass; the assignment stays at
#                     the parity tier. No other estimator reads it.
#   knn_precision     (str,  env SRML_TORCH_KNN_PRECISION)     the products of exact
#                     kNN's top-k scan: "float32" (the default, exact), "bfloat16"
#                     or "int8", which rank an oversampled candidate pool that an
#                     exact f32 re-rank cuts back to k (ops/knn.py); the JAX
#                     package's knn.pallas_precision. An unknown value raises.
#

from __future__ import annotations

import os
from typing import Any, Dict

_DEFAULTS: Dict[str, Any] = {
    "device": "cuda",
    "parity_precision": "highest",
    "fast_math": False,
    "knn_precision": "float32",
}

_ENV_KEYS: Dict[str, str] = {
    "device": "SRML_TORCH_DEVICE",
    "parity_precision": "SRML_TORCH_PARITY_PRECISION",
    "fast_math": "SRML_TORCH_FAST_MATH",
    "knn_precision": "SRML_TORCH_KNN_PRECISION",
}

_overrides: Dict[str, Any] = {}


def _coerce(key: str, raw: str) -> Any:
    if isinstance(_DEFAULTS[key], bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return raw


def get(key: str) -> Any:
    """Resolution order: programmatic set() > environment > default."""
    if key not in _DEFAULTS:
        raise KeyError(f"Unknown config key '{key}'; known: {sorted(_DEFAULTS)}")
    if key in _overrides:
        return _overrides[key]
    env = os.environ.get(_ENV_KEYS[key])
    if env:
        return _coerce(key, env)
    return _DEFAULTS[key]


def set(key: str, value: Any) -> None:  # spark-conf style name (shadows the builtin deliberately)
    if key not in _DEFAULTS:
        raise KeyError(f"Unknown config key '{key}'; known: {sorted(_DEFAULTS)}")
    _overrides[key] = value


def unset(key: str) -> None:
    _overrides.pop(key, None)
