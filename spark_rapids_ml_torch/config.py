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
# The streamed out-of-core fit (ops/streaming.py) and its ingest (ops/ingest.py,
# ops/device_cache.py); the JAX package's keys of the same names:
#   stream_threshold_bytes  (int, env SRML_TORCH_STREAM_THRESHOLD_BYTES) PCA,
#                     KMeans, LinearRegression and both random forests stream
#                     their rows through the device in batches when n_rows *
#                     n_cols * itemsize exceeds it, and in one process DBSCAN's
#                     transform and a kNN item set above it stay on the host
#                     (ops/pairwise_streaming.py); 0 or None turns streaming
#                     off. Default "auto": on the
#                     card half of its total memory (40 GB on an 80 GB H100: an
#                     X that large leaves no room for the fit's own buffers
#                     in-core), on the CPU the JAX package's 4 GiB, so CPU runs
#                     route as the JAX package does. The JAX package's 4 GiB is a
#                     fact about a TPU's HBM, not a rule for the card. When
#                     the ranks of a multi-process fit share a card (more
#                     ranks than cards, parallel/bootstrap.py), "auto" is the
#                     card's half divided by the ranks on that card.
#   stream_batch_rows (int, env SRML_TORCH_STREAM_BATCH_ROWS)  rows per streamed
#                     batch, default 1 << 20 (the JAX package's).
#   cache.enabled     (bool, env SRML_TORCH_CACHE_ENABLED)     keep the batches of
#                     a multi-pass streamed fit (KMeans; the item tiles of a
#                     streamed kNN search or DBSCAN transform) on the device and
#                     replay them in later passes; default True.
#   cache.hbm_budget_bytes (int, env SRML_TORCH_CACHE_HBM_BUDGET_BYTES) the
#                     cache's byte budget; an X above it caches a prefix of its
#                     batches and streams the rest every pass. Default "auto":
#                     on the card half of the device memory free when the fit
#                     starts, less the device batches in flight (so the cache
#                     never starves the stream it serves); on the CPU the JAX
#                     package's 2 GiB. 0 or None caches nothing.
#   ingest.zero_copy  (bool, env SRML_TORCH_INGEST_ZERO_COPY)  a contiguous slice
#                     whose dtype the device casts exactly is uploaded as it is,
#                     a view; off, every batch takes a counted host copy.
#   ingest.staging_pool_rows (int, env SRML_TORCH_INGEST_STAGING_POOL_ROWS)
#                     rows per buffer of the host staging (the pinned ring's
#                     chunk on the card, the counted copy's pool); 0 (default)
#                     = ops/ingest.py's measured chunk size.
#

from __future__ import annotations

import os
from typing import Any, Dict, Optional

AUTO = "auto"

_DEFAULTS: Dict[str, Any] = {
    "device": "cuda",
    "parity_precision": "highest",
    "fast_math": False,
    "knn_precision": "float32",
    "stream_threshold_bytes": AUTO,
    "stream_batch_rows": 1 << 20,
    "cache.enabled": True,
    "cache.hbm_budget_bytes": AUTO,
    "ingest.zero_copy": True,
    "ingest.staging_pool_rows": 0,
}

# the JAX package's defaults (spark_rapids_ml_tpu/config.py), which the "auto"
# keys take on the CPU
CPU_STREAM_THRESHOLD_BYTES = 4 << 30
CPU_CACHE_BUDGET_BYTES = 2 << 30

_ENV_KEYS: Dict[str, str] = {
    key: "SRML_TORCH_" + key.upper().replace(".", "_") for key in _DEFAULTS
}

_overrides: Dict[str, Any] = {}


def _coerce(key: str, raw: str) -> Any:
    default = _DEFAULTS[key]
    if isinstance(default, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(default, int) or default == AUTO:
        word = raw.strip().lower()
        if word == AUTO and default == AUTO:
            return AUTO
        if word == "none":
            return None
        return int(word)
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


def stream_threshold_bytes(device) -> Optional[int]:
    """The stream threshold for a fit on `device`; None when streaming is off."""
    value = get("stream_threshold_bytes")
    if value == AUTO:
        if device.type == "cuda":
            import torch

            from .parallel.partitioner import active_partitioner

            share = torch.cuda.get_device_properties(device).total_memory // 2
            return share // active_partitioner().ranks_on_device()
        return CPU_STREAM_THRESHOLD_BYTES
    return int(value) if value else None


def cache_budget_bytes(device, in_flight_bytes: int) -> int:
    """The batch cache's budget for a fit on `device` that keeps
    `in_flight_bytes` of device batches in flight; 0 caches nothing."""
    value = get("cache.hbm_budget_bytes")
    if value == AUTO:
        if device.type == "cuda":
            import torch

            free, _ = torch.cuda.mem_get_info(device)
            return max(0, free // 2 - int(in_flight_bytes))
        return CPU_CACHE_BUDGET_BYTES
    return int(value) if value else 0
