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
# Across the ranks of a process group (parallel/partitioner.py) the items are
# sharded, each rank holding its own, and each rank asks for the neighbors of
# its own queries. Two routes, the JAX package's two multi-device ones:
#   * `exact_knn_distributed`, the all-gather merge (its
#     `_knn_local_then_merge_fn`): the queries are gathered, each rank scans
#     its shard with `exact_knn_single` (the top-k kernel in the form
#     knn_precision names, the exact re-rank for the narrow forms) at
#     k_local = min(k, its rows), a shard with no rows giving only sentinels
#     (d2 +inf, id -1); the candidates, padded to k, are gathered in one
#     all-gather and merged exactly by `merge_topk` in rank-major pool order,
#     so ties go to the lower global position, the single-process rule; each
#     rank keeps the rows of its own queries;
#   * `exact_knn_ring`, the ring (the JAX package's `exact_knn_ring`): the
#     queries stay on their rank and the item shard, padded to the largest
#     shard (`Ring`), rotates rank to rank by `Partitioner.ring_shift` with its
#     valid mask, its cached norms and its ids; each of the P hops runs the top-k
#     kernel of the local queries against the shard held, at k_hop = min(k,
#     padded shard rows), and merges the hop into a running top-k. Peak memory
#     a rank: two padded shards (the one held and the one arriving) beside the
#     queries. Two departures from the JAX ring, both stated:
#       - ties: the running merge breaks a tie by global position
#         (`select_topk_by_id`), not by hop order. The JAX ring concatenates
#         [best, hop], so its ties go to whichever shard reached the query's
#         device first. Here both routes give the single-process search's
#         bits;
#       - precision: the JAX ring resolves its strategy without fusable=True,
#         so it scans in exact f32 whatever knn_precision says; so does this
#         one, in every form.
# A pair's d2 from the kernel does not depend on the item range it is scanned
# in, so in f32 both routes return the single-process search's distances and
# ids bit for bit. The ring's running merge, `merge_by_position`, is also the
# streamed scan's (ops/pairwise_streaming.py, an item tile a step). Not
# ported: the approx_max_k selection strategy (knn.selection=approx) and the
# IVF / CAGRA indexes.
#

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Iterator, List, Optional, Tuple

import torch

from ..parallel.partitioner import Ring
from ..utils import span
from ._precision import pdot
from .selection import mask_invalid, merge_topk, select_topk_by_id

if TYPE_CHECKING:  # ops/topk.py imports this module
    from ..parallel.partition import PartitionDescriptor
    from ..parallel.partitioner import Partitioner
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


def _item_ids(ids: Optional[torch.Tensor], layout: "PartitionDescriptor", n: int,
              device: torch.device) -> torch.Tensor:
    """The shard's int64 item ids: `ids`, else the global positions."""
    if ids is not None:
        return ids
    return torch.arange(layout.offset, layout.offset + n, dtype=torch.int64, device=device)


def exact_knn_distributed(
    Q: torch.Tensor, X: torch.Tensor, valid: torch.Tensor, k: int,
    part: "Partitioner", layout: "PartitionDescriptor",
    *, x2: Optional[torch.Tensor] = None, precision: Optional[str] = None,
    items: Optional["NarrowRows"] = None, ids: Optional[torch.Tensor] = None,
    query_rows: Optional[List[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of this rank's queries Q against the items of every rank, by
    the all-gather merge (module header): (squared distances ascending
    (nq, min(k, layout.m)) f32, int64 item ids). X, valid, x2 and `items`
    are this rank's item shard, global rows [layout.offset, + its rows);
    `ids` its int64 item ids (default: the global positions). `query_rows`
    is every rank's query count in rank order, when the caller has gathered
    them. Collective: every rank calls it, with or without queries or items."""
    nq, d = Q.shape
    if query_rows is None:
        query_rows = [r for (r,) in part.all_gather_ints(nq)]
    with span("exchange", route="allgather"):
        Qall = part.all_gather_rows(Q, query_rows)
    n, nq_all = X.shape[0], Qall.shape[0]
    k_eff = min(int(k), layout.m)
    d2 = torch.full((nq_all, k_eff), math.inf, dtype=torch.float32, device=X.device)
    cand = torch.full((nq_all, k_eff), -1, dtype=torch.int64, device=X.device)
    if n and nq_all:
        local_d2, idx = exact_knn_single(Qall, X, valid, min(k_eff, n), x2=x2,
                                         precision=precision, items=items)
        d2[:, : idx.shape[1]] = local_d2
        cand[:, : idx.shape[1]] = _item_ids(ids, layout, n, X.device)[idx.long()]
    with span("exchange", route="allgather"):
        # one all-gather of (d2 bits, id as two words) per candidate
        packed = torch.cat([d2.view(torch.int32)[..., None],
                            cand.view(torch.int32).reshape(nq_all, k_eff, 2)], dim=-1)
        pool = part.all_gather_rows(packed, [nq_all] * part.process_count)
        pool = pool.view(part.process_count, nq_all, k_eff, 3)
    if nq == 0:
        return d2[:0], cand[:0]
    with span("merge"):
        q0 = sum(query_rows[: part.process_index])
        mine = pool[:, q0 : q0 + nq].transpose(0, 1)  # (nq, P, k_eff, 3), rank-major
        width = part.process_count * k_eff
        pool_d2 = mine[..., 0].contiguous().view(torch.float32).reshape(nq, width)
        pool_ids = mine[..., 1:].contiguous().view(torch.int64).reshape(nq, width)
        return merge_topk(pool_d2, pool_ids, k_eff)


def exact_knn_ring(
    Q: torch.Tensor, X: torch.Tensor, valid: torch.Tensor, k: int,
    part: "Partitioner", layout: "PartitionDescriptor",
    *, x2: Optional[torch.Tensor] = None, ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of this rank's queries Q against the items of every rank, by
    the ring (module header): (squared distances ascending (nq, min(k,
    layout.m)) f32, int64 item ids), in exact f32. X, valid, x2 and `ids` as
    in exact_knn_distributed. Collective: every rank calls it."""
    rows = [sz for _, sz in layout.parts_rank_size]
    shard = max(rows)
    n = X.shape[0]
    nq = Q.shape[0]
    dev = X.device
    k_eff = min(int(k), layout.m)
    k_hop = min(k_eff, shard)
    if x2 is None:
        x2 = center_norms_sq(X)
    # the held shard, padded to the largest: invalid rows with id -1
    ring = Ring(part, rows, (X, 0.0), (valid, False), (x2, 0.0),
                (_item_ids(ids, layout, n, dev), -1))
    best_d2 = torch.full((nq, k_eff), math.inf, dtype=torch.float32, device=dev)
    best_pos = torch.full((nq, k_eff), -1, dtype=torch.int64, device=dev)
    best_ids = torch.full((nq, k_eff), -1, dtype=torch.int64, device=dev)
    for owner in ring.hops():
        if nq and shard:
            from .topk import fused_topk

            Xc, vc, x2c, uc = ring.tensors
            with span("select", precision="float32", k=k_hop):
                hop_d2, idx = fused_topk(Q, Xc, vc, k_hop, x2=x2c)
            with span("merge"):
                idx = idx.long()
                pos = torch.where(idx < rows[owner], ring.starts[owner] + idx, -1)
                best_d2, best_pos, best_ids = merge_by_position(
                    best_d2, best_pos, hop_d2, pos, k_eff, (best_ids, uc[idx]))
    return best_d2, best_ids


def merge_by_position(
    best_d2: torch.Tensor, best_pos: torch.Tensor, d2: torch.Tensor, pos: torch.Tensor, k: int,
    *carried: Tuple[torch.Tensor, torch.Tensor],
) -> Tuple[torch.Tensor, ...]:
    """Fold candidates (d2, int64 global positions `pos`, -1 for none) into
    a running top-k (best_d2, best_pos): the exact smallest k of the pool,
    ties to the lower global position whatever the pool order
    (select_topk_by_id). `carried` are (running, new) pairs of tensors
    aligned with the two (the ring's item ids), gathered alike. Returns
    (d2, positions, *carried) of the new running top-k."""
    pool_pos = torch.cat([best_pos, pos], dim=1)
    best_d2, sel = select_topk_by_id(torch.cat([best_d2, d2], dim=1), pool_pos, k)
    return (best_d2, torch.gather(pool_pos, 1, sel),
            *(torch.gather(torch.cat([run, new], dim=1), 1, sel) for run, new in carried))
