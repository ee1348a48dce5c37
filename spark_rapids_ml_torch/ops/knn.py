#
# k-nearest-neighbor ops of the PyTorch port: the in-core, one-device part of
# the JAX package's ops/knn.py.
#   * `_block_sq_dists`, `query_blocks`: the blocked pairwise squared
#     distances that DBSCAN's neighbor passes and the count and top-k kernels'
#     plain versions are built on;
#   * `exact_knn_single`: the host entry of exact kNN, routed to the fused
#     top-k (ops/topk.py::fused_topk, the CUDA kernel csrc/topk.cu on the
#     card) in the form the config key knn_precision names, as the JAX
#     package's `_exact_knn_resolved` routes its pallas_fused strategy: the
#     float32 form's answer is final; the bfloat16 and int8 forms rank an
#     oversampled pool that `parity_rerank_sq` re-ranks in exact f32, so the
#     returned distances are exact and only the id set is approximate. The
#     JAX package's blocked `_exact_knn_scan` is the kernel's plain version,
#     ops/topk.py::topk_plain;
#   * `parity_rerank_sq`: the exact re-rank of a candidate pool (plain
#     PyTorch: a gather and a difference form; the JAX package has no kernel
#     for it either);
#   * `center_norms_sq`: the squared norms a fitted model caches, computed by
#     the same reduce as the kernel's wrapper.
#
# On one device the JAX package's `exact_knn_distributed` is `exact_knn_single`
# followed by the square root, so the port has no separate entry for it. Not
# ported: the approx_max_k selection strategy (knn.selection=approx), the ring
# and multi-process routes, the streamed scan, and the IVF / CAGRA indexes.
#

from __future__ import annotations

from typing import TYPE_CHECKING, Iterator, Optional, Tuple

import torch

from ..utils import span
from ._precision import pdot
from .selection import mask_invalid, merge_topk

if TYPE_CHECKING:  # ops/topk.py imports this module
    from .topk import NarrowRows

# Bytes of one (query block, all items) f32 distance tile: the scans below
# bound their transient memory by it (the card holds several such tiles at once
# while an expression is evaluated).
TILE_BYTES = 1 << 30


def _block_sq_dists(
    Q: torch.Tensor, X: torch.Tensor, x2: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(nq, n) clamped squared euclidean distances max(q2 − 2·q·x + x2, 0), by
    the matmul expansion in full f32. `x2` is the precomputed item-norm term
    Σ X², passed to keep it out of a per-block scan."""
    q2 = torch.sum(Q * Q, dim=1, keepdim=True)
    if x2 is None:
        x2 = torch.sum(X * X, dim=1)
    # in place on the fresh product: (-2·q·x) + q2 + x2 rounds as q2 − 2·q·x + x2
    return pdot(Q, X.T).mul_(-2.0).add_(q2).add_(x2).clamp_(min=0.0)


def query_blocks(nq: int, n_items: int, block: Optional[int] = None) -> Iterator[slice]:
    """Slices of the query rows, each of `block` rows (default: as many as keep
    a (block, n_items) f32 tile within TILE_BYTES)."""
    if block is None:
        block = max(1, TILE_BYTES // (4 * max(n_items, 1)))
    for s in range(0, nq, block):
        yield slice(s, min(s + block, nq))


def center_norms_sq(centers: torch.Tensor) -> torch.Tensor:
    """Σ centers² per row, by the reduce the top-k wrapper uses, so a cached
    norm is the value the wrapper would compute."""
    return torch.sum(centers * centers, dim=1)


def parity_rerank_sq(
    Q: torch.Tensor, X: torch.Tensor, valid: torch.Tensor, cand_idx: torch.Tensor, k: int,
    block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 re-rank of a candidate pool cand_idx (nq, kc) int32 of item
    positions (the JAX package's parity_rerank_sq): gather the candidates,
    their squared distances by the difference form Σ (x − q)² (no expansion,
    no cancellation), the sentinel mask, and the exact smallest k of the pool
    (merge_topk: ties to the earlier pool position). Query-blocked so that a
    block's gathered (block, kc, d) f32 stays within TILE_BYTES (default)."""
    nq, kc = cand_idx.shape
    k = min(int(k), kc)
    if block is None:
        block = max(1, TILE_BYTES // (4 * max(kc * X.shape[1], 1)))
    d2_out = torch.empty((nq, k), dtype=torch.float32, device=Q.device)
    id_out = torch.empty((nq, k), dtype=torch.int32, device=Q.device)
    for s in range(0, nq, block):
        cand = cand_idx[s : s + block]
        idx = cand.long()
        d2 = torch.sum((X[idx] - Q[s : s + block, None, :]) ** 2, dim=-1)
        d2_out[s : s + block], id_out[s : s + block] = merge_topk(
            mask_invalid(d2, valid[idx]), cand, k
        )
    return d2_out, id_out


def exact_knn_single(
    Q: torch.Tensor, X: torch.Tensor, valid: torch.Tensor, k: int,
    *, x2: Optional[torch.Tensor] = None, precision: Optional[str] = None,
    items: Optional["NarrowRows"] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of the rows of Q against the valid rows of X on their device:
    (squared distances ascending (nq, min(k, n)) f32, int32 item positions).
    `x2` is the items' cached squared norms. `precision` is the top-k scan's
    form (default: the config key knn_precision). float32 is exact; bfloat16
    and int8 take a pool of oversample_width(k) candidates from the scan and
    re-rank it in exact f32 (then once more at width k when the pool was
    wider), so the returned (d2, ids) are parity_rerank_sq of the returned
    ids, bit for bit, and only the id set is approximate. `items` is X's
    narrow operand (ops/topk.py::narrow_rows) when the caller caches one. The
    spans "select" and "rerank" time the two stages."""
    from .selection import resolve_fused_precision
    from .topk import K_MAX, fused_topk, oversample_width

    n = X.shape[0]
    k = min(int(k), n)
    precision = resolve_fused_precision(precision)
    kc = oversample_width(k, n, precision)
    if precision == "float32":
        with span("select", precision=precision, k=k):
            return fused_topk(Q, X, valid, k, x2=x2)
    if kc > K_MAX:
        raise ValueError(
            f"k={k} in the {precision} form needs a candidate pool of {kc} > K_MAX = {K_MAX} "
            f"(k + max(8, k // 4)); take k <= 205 there, or knn_precision='float32'"
        )
    with span("select", precision=precision, k=kc):
        _, idx = fused_topk(Q, X, valid, kc, x2=x2, precision=precision, items=items)
    with span("rerank", precision=precision, k=k):
        d2, ids = parity_rerank_sq(Q, X, valid, idx, k)
        if kc != k:
            # re-derive the returned distances at width k, so that they are
            # parity_rerank_sq of the returned ids exactly (a width-kc reduce
            # may round another way than a width-k one)
            d2, ids = parity_rerank_sq(Q, X, valid, ids, k)
    return d2, ids
