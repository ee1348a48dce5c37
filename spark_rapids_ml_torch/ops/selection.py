#
# Exact smallest-k selection of the PyTorch port: the exact half of the JAX
# package's ops/selection.py (INVALID_D2, mask_invalid, select_topk with
# strategy exact_full, merge_topk, top_k_max), in the port's own copy.
#
# Contracts kept from the JAX package:
#   * invalid candidates mask to INVALID_D2, a large FINITE sentinel
#     (f32max/2), never inf: inf entries feeding a later recomputation
#     (inf - inf) are NaN factories;
#   * select_topk clamps its input at INVALID_D2, so a caller's inf (or an
#     overflowed distance) ranks as the sentinel does;
#   * ties resolve lowest index first, as jax.lax.top_k resolves them.
#
# torch.topk does not promise an order among equal values, and a stable full
# sort is far too slow at millions of candidates per row. So the selection
# runs on a unique int64 key: the f32 value's bits, made monotone as a signed
# int32 (negative floats flip their 31 low bits), in the high half and the
# candidate's index in the low half. Keys are unique and order as (value,
# index), so torch.topk of the key returns exactly the lowest-index-first
# smallest k, with no tie left to resolve.
#
# `resolve_fused_precision` resolves the fused top-k scan's products
# (float32, bfloat16 or int8; the config key knn_precision). The approximate
# selection strategy (approx_max_k) is not ported.
#

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# The fused top-k scan's forms (the JAX package's FUSED_PRECISIONS): exact f32,
# and the two that rank an approximate pool for an exact re-rank.
FUSED_PRECISIONS = ("float32", "bfloat16", "int8")

# Large-finite invalid sentinel: no real squared distance on f32 inputs reaches
# it before the clamp, and a sum of two sentinels stays finite.
INVALID_D2 = float(np.float32(np.finfo(np.float32).max / 2))


def mask_invalid(d2: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """d2 with the positions where `valid` (broadcast against d2) is False set
    to the sentinel."""
    return torch.where(valid, d2, INVALID_D2)


def _order_key(d2: torch.Tensor, low: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 keys ordering as (d2, low): the f32 bits made monotone as a
    signed int, shifted into the high half, and `low` (int64 in [0, 2^32),
    default the index along the last axis, which makes the keys unique) in
    the low half."""
    key = d2.contiguous().view(torch.int32).to(torch.int64)
    key ^= (key >> 31) & 0x7FFFFFFF  # negative floats: reverse their order
    key <<= 32
    if low is None:
        low = torch.arange(d2.shape[-1], dtype=torch.int64, device=d2.device)
    key |= low
    return key


def select_topk(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis of f32 `d2`, clamped at INVALID_D2:
    (values ascending, int32 indices), ties lowest index first. k is clamped
    to the axis length."""
    if d2.dtype != torch.float32:
        raise TypeError(f"select_topk takes float32, got {d2.dtype}")
    n = d2.shape[-1]
    if n >= 2**31:
        raise ValueError(f"select_topk takes fewer than 2^31 candidates, got {n}")
    k = min(int(k), n)
    d2 = torch.clamp(d2, max=INVALID_D2)
    pos = torch.topk(_order_key(d2), k, dim=-1, largest=False, sorted=True).indices
    return torch.gather(d2, -1, pos), pos.to(torch.int32)


def merge_topk(
    pool_d2: torch.Tensor, pool_ids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact smallest-k of an already-selected candidate pool: (values
    ascending, the pool's ids at the chosen positions). Ties go to the earlier
    pool position."""
    d2, pos = select_topk(pool_d2, k)
    return d2, torch.gather(pool_ids, -1, pos.long())


def select_topk_by_id(
    pool_d2: torch.Tensor, pool_ids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact smallest-k of a candidate pool, clamped at INVALID_D2 as
    select_topk is: (values ascending, int64 pool positions). Ties go to the
    lower id of `pool_ids` (from -1 to 2^31 - 2), whatever the pool order."""
    k = min(int(k), pool_d2.shape[-1])
    d2 = torch.clamp(pool_d2, max=INVALID_D2)
    low = pool_ids.to(torch.int64) + 1
    pos = torch.topk(_order_key(d2, low), k, dim=-1, largest=False, sorted=True).indices
    return torch.gather(d2, -1, pos), pos


def top_k_max(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest-k along the last axis of f32 `scores`: (values descending, int32
    indices), ties lowest index first. The random forest's per-level feature
    subsets pick through it."""
    d2, idx = select_topk(-scores, k)
    return -d2, idx


def resolve_fused_precision(precision: Optional[str] = None) -> str:
    """The fused top-k scan's products: the caller's `precision`, else the
    config key knn_precision (set() > env > default "float32"). The port has no
    tuning table. A non-float32 form obliges its caller to re-rank the pool in
    exact f32 (ops/knn.py::parity_rerank_sq). Raises on an unknown value."""
    from .. import config as _config

    if precision is None:
        precision = str(_config.get("knn_precision"))
    if precision not in FUSED_PRECISIONS:
        raise ValueError(
            f"knn_precision must be one of {FUSED_PRECISIONS}, got {precision!r}"
        )
    return precision
