#
# Count-below-eps reduction, DBSCAN's core-point test (counterpart of the count
# half of the JAX package's ops/pallas_select.py: _count_kernel, _fused_count,
# fused_count_below): per query row, how many valid items lie within eps², by
# max(q2 − 2·q·x + x2, 0) ≤ eps², self included when Q is X. eps² is a runtime
# operand.
#
# `fused_count_below` launches the CUDA kernel csrc/count.cu for tensors on the
# card, always (the JAX package's `knn.selection` / `pallas_min_items` gate is a
# fact about the TPU), and runs `count_below_plain`, the same function in plain
# PyTorch, for tensors on the CPU. The kernel computes the cross terms in 3xTF32
# on the tensor cores, at f32 accuracy (csrc/tf32x3.cuh); its design and its
# bound on the H100 are in the source's header, and `_plan` mirrors its launch.
#

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .knn import _block_sq_dists, query_blocks

QUERY_TILE = 128  # csrc/count.cu CQT: queries of a block
ITEM_TILE = 128  # CIT: items of a tile
DEPTH = 32  # CDK: feature columns of a ring stage
STAGES = 3  # CSTAGES
ROW_FLOATS = DEPTH + 4  # CLDK: a staged row's stride
WARPS_N = 2  # CWARPS_N: warps that share a query
MAX_SMEM_BYTES = 227 * 1024  # the most a block may use on the H100


def count_below_plain(
    Q: torch.Tensor, X: torch.Tensor, valid: torch.Tensor, eps2: float,
    block: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: int32 (nq,) counts, by a blocked
    (query block × all items) scan of `_block_sq_dists`."""
    x2 = torch.sum(X * X, dim=1)
    out = torch.empty((Q.shape[0],), dtype=torch.int32, device=Q.device)
    for sl in query_blocks(Q.shape[0], X.shape[0], block):
        hit = (_block_sq_dists(Q[sl], X, x2) <= eps2) & valid[None, :]
        out[sl] = hit.sum(dim=1, dtype=torch.int32)
    return out


def _plan(nq: int, n: int, d: int) -> dict:
    """The kernel's launch (csrc/count.cu srml_count): one block a tile of
    QUERY_TILE queries scanning every item tile; at d <= DEPTH the query
    tile's fragments stay in registers and only the items pass through the
    ring. Returns blocks, resident, item tiles and the dynamic shared memory."""
    resident = d <= DEPTH
    rows = (0 if resident else QUERY_TILE) + ITEM_TILE
    return dict(blocks=-(-nq // QUERY_TILE), resident=resident,
                item_tiles=-(-n // ITEM_TILE), column_chunks=-(-d // DEPTH),
                smem=4 * STAGES * rows * ROW_FLOATS + 4 * WARPS_N * QUERY_TILE)


def fused_count_below(
    Q: torch.Tensor, X: torch.Tensor, valid: torch.Tensor, eps2: float
) -> torch.Tensor:
    """int32 (nq,) count, per row of Q (nq, d) f32, of the rows of X (n, d) f32
    with valid (n,) bool set that lie within squared distance eps2."""
    nq, d = Q.shape
    n = X.shape[0]
    _cuda.require(Q, "Q", (nq, d))
    _cuda.require(X, "X", (n, d))
    _cuda.require(valid, "valid", (n,), dtype=torch.bool)
    if n >= 2**31:
        raise ValueError(f"the count kernel takes fewer than 2^31 items, got {n}")
    if _cuda.device_kind(Q, X, valid) == "cpu":
        return count_below_plain(Q, X, valid, eps2)
    fn = _cuda.entry("count")
    q2 = torch.sum(Q * Q, dim=1)
    # the mask rides in the norm operand: an invalid item's norm reads -1
    x2m = torch.where(valid, torch.sum(X * X, dim=1), -1.0)
    counts = torch.empty((nq,), dtype=torch.int32, device=Q.device)
    _cuda.check(
        fn(Q.data_ptr(), q2.data_ptr(), nq, d, X.data_ptr(), x2m.data_ptr(), n,
           float(eps2), counts.data_ptr(), _cuda.stream_of(Q)),
        "count kernel",
    )
    fused_count_below.launches += 1
    return counts


fused_count_below.launches = 0
