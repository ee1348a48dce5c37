#
# Out-of-core pairwise tier of the PyTorch port (counterpart of the JAX
# package's ops/pairwise_streaming.py): exact kNN and DBSCAN with the dataset
# in host memory. The card holds one query block, one item tile (with its
# squared norms, its valid mask and, for DBSCAN's rounds, the labels it
# offers) and O(query block) running state; the item tiles stream from the
# host through the pinned ring (ops/ingest.py), one tile uploaded ahead of the
# one being scanned (ops/streaming.py::_prefetch), and the device batch cache
# (ops/device_cache.py) keeps the tiles the first sweep uploaded, so the other
# sweeps of one call replay them (a prefix of them when the items exceed the
# budget).
#   * `streaming_exact_knn`: per query block, one sweep of the item tiles; each
#     tile runs the top-k kernel (ops/topk.py::fused_topk, csrc/topk.cu on the
#     card) at k_tile = min(k, tile rows), and its candidates fold into the
#     running top-k by global position (ops/knn.py::merge_by_position, the
#     ring's merge), so ties go to the lower item row, as in one launch over
#     every item. The top-k kernel's d2 of a pair does not depend on the item
#     range it is scanned in, so the f32 answer is the in-core search's, bit
#     for bit, given the same item norms: the model passes its stored norms as
#     a tile extra, and a call without them computes each tile's once, at its
#     upload (counted as knn.x2_tile_computes). knn_precision does not apply:
#     the stream scans in exact f32, as the JAX package's streamed scan and
#     the port's kNN ring do.
#   * `streaming_dbscan_fit_predict`: one sweep for the core mask, each tile
#     through the count kernel (ops/count.py::fused_count_below, csrc/count.cu),
#     the int32 counts added over the tiles (exact in any order); then one
#     sweep a propagation round, each tile through the plain min-label scan
#     (ops/dbscan.py::_min_labels_against) with a running amin, the hook and
#     the two pointer-jumping steps on the host in numpy between rounds
#     (O(n), as in the JAX package); the border pass reuses the last round's
#     minima when the loop converged; labels compacted by
#     ops/dbscan.py::_compact_labels. Under the cosine metric a zero row raises
#     ValueError, then the rows are normalized once in a host copy and
#     eps2 = 2·eps. The X tiles and their norms are uploaded once a call and
#     replayed by every sweep; a round's labels ride beside each tile, uploaded
#     per (query block, tile) (O(tile) bytes; the JAX package re-keys the whole
#     tile a round instead).
#
# Tiles: rows [start, start + rows) of the host array in a device buffer of
# `item_block` rows (at most n), the rows from `rows` on zero and invalid.
# `query_block` (4,096 for kNN, 8,192 for DBSCAN) and `item_block` (131,072)
# are parameters, as in the JAX package, not config keys. The bytes of the
# tiles in flight (PREFETCH_DEPTH + 1 tiles with their extras) are left out
# of the cache's budget (config.cache_budget_bytes).
#
# Spans and counters, under the JAX package's names: `pairwise.query_block`
# (each kNN sweep), `stream.ingest` (each tile upload), `select` (the top-k
# launches) and `merge` (the running merge); `core_mask`, `propagate` and
# `border` (DBSCAN's passes, the in-core route's names); counters
# knn.x2_tile_computes, dbscan.core_blocks (query blocks of the core-mask
# sweep) and dbscan.rounds; ops/dbscan.py::_propagate_labels.rounds counts
# the rounds too, as the in-core route does.
#
# Not ported: the mesh variants (`_shard_blocks`, `_mk_tile_*_mesh`; the port
# has one device a process), the streamed ring under a process group (DBSCAN
# and kNN keep their in-core ring and all-gather routes there), the approx
# selection strategy's re-rank, and the retry policy and fault points of the
# reliability plane.
#

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils import span
from . import ingest
from .count import fused_count_below
from .dbscan import _BIG, _compact_labels, _min_labels_against, _propagate_labels
from .device_cache import batch_cache, cached_build
from .knn import center_norms_sq, merge_by_position
from .streaming import PREFETCH_DEPTH, _prefetch, in_flight_bytes

ITEM_BLOCK = 131_072
KNN_QUERY_BLOCK = 4_096
DBSCAN_QUERY_BLOCK = 8_192

counters = {}


def reset_counters() -> None:
    counters.update({"knn.x2_tile_computes": 0, "dbscan.core_blocks": 0, "dbscan.rounds": 0})


reset_counters()


@dataclass
class Tile:
    """One item tile on the device: host rows [start, start + rows) in a
    buffer of the tile's full size, its squared norms and its valid mask (the
    first `rows` rows)."""

    start: int
    rows: int
    X: torch.Tensor
    norms: torch.Tensor
    valid: torch.Tensor

    def tensors(self):
        return [self.X, self.norms, self.valid]


def tile_bytes(block: int, d: int) -> int:
    """Device bytes of the tiles a sweep keeps in flight: their rows and
    three row-aligned extras (the norms, the mask, DBSCAN's labels)."""
    return in_flight_bytes(block, d, 4, 3)


class _Uploader:
    """The host staging and the pinned ring of one call's uploads."""

    def __init__(self, device: torch.device, d: int) -> None:
        self.device = device
        self.pool = ingest.StagingPool(device)
        self.ring = None
        if device.type == "cuda":
            rows = ingest.resolve_staging_pool_rows(d=d, itemsize=4)
            self.ring = ingest.PinnedRing(device, rows * max(d, 1) * 4)

    def rows(self, a: np.ndarray, s: int, e: int, full: Optional[int] = None,
             fill=0, slot: str = "X") -> torch.Tensor:
        """Rows [s, e) of the host array on the device, in a buffer of `full`
        rows (default e - s) whose rows past e - s hold `fill`."""
        full = e - s if full is None else int(full)
        dtype = np.dtype(a.dtype)
        tdtype = ingest.host_tensor(np.empty(0, dtype)).dtype
        blk = ingest.stage_block(a, s, e, dtype, self.pool, slot=slot)
        if self.device.type == "cuda":
            t = ingest.upload(blk, self.device, tdtype, self.ring, full)
            if full > e - s:
                t[e - s :].fill_(fill)
            return t
        if full > e - s:  # on the CPU the upload shares the block: pad a copy
            pad = np.full((full,) + blk.shape[1:], fill, dtype)
            pad[: e - s] = blk
            blk = pad
        return ingest.upload(blk, self.device, tdtype)


def _device_blocks(X: np.ndarray, block: int, up: _Uploader, norms: Optional[np.ndarray] = None,
                   cache=None, cache_key=None) -> Iterator[Tile]:
    """The item tiles of host X (n, d) f32, `block` rows each (the ragged tail
    in a full-size buffer, zero and invalid from its last row on), each with
    its squared norms: `norms`' rows when given, else center_norms_sq of the
    tile, computed once at its upload. Cached tiles replay; one tile is
    uploaded ahead of the one the caller scans."""
    n = X.shape[0]

    def build(s: int, e: int) -> Tile:
        xd = up.rows(X, s, e, block, slot="X")
        if norms is None:
            x2 = center_norms_sq(xd)
            counters["knn.x2_tile_computes"] += 1
        else:
            x2 = up.rows(norms, s, e, block, slot="x2")
        valid = torch.arange(block, device=xd.device) < (e - s)
        return Tile(s, e - s, xd, x2, valid)

    def gen() -> Iterator[Tile]:
        for s in range(0, n, block):
            e = min(s + block, n)
            yield cached_build(cache, cache_key, s // block, lambda s=s, e=e: build(s, e))

    return _prefetch(gen(), depth=PREFETCH_DEPTH)


def _tile_topk_merge(Qb: torch.Tensor, tile: Tile, k: int, best):
    """Fold one tile into the query block's running top-k `best` (d2, global
    positions): the top-k kernel at k_tile = min(k, tile rows), then the
    exact merge by global position. The tile's invalid rows name position -1."""
    from .topk import fused_topk

    with span("select", precision="float32", k=min(k, tile.X.shape[0])):
        d2, idx = fused_topk(Qb, tile.X, tile.valid, min(k, tile.X.shape[0]), x2=tile.norms)
    with span("merge"):
        idx = idx.long()
        pos = torch.where(idx < tile.rows, tile.start + idx, -1)
        return merge_by_position(best[0], best[1], d2, pos, k)


def _check_blocks(query_block: int, item_block: int) -> None:
    if query_block < 1 or item_block < 1:
        raise ValueError(f"query_block and item_block must be positive, got {query_block}, "
                         f"{item_block}")


def streaming_exact_knn(
    Q: np.ndarray, X: np.ndarray, k: int, device: torch.device,
    query_block: int = KNN_QUERY_BLOCK, item_block: int = ITEM_BLOCK,
    norms: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN of the rows of host Q (nq, d) against the rows of host X
    (n, d), both f32: (squared distances ascending (nq, min(k, n)) f32,
    int64 item rows), in exact f32 (module header). `norms` (n,) f32 are
    X's squared norms when the caller holds them. The items are swept once
    per query block, the later sweeps replayed from the device cache."""
    _check_blocks(query_block, item_block)
    n, d = X.shape
    nq = Q.shape[0]
    k_eff = min(int(k), n)
    block = min(int(item_block), n)
    out_d = np.empty((nq, k_eff), np.float32)
    out_i = np.empty((nq, k_eff), np.int64)
    if nq == 0 or k_eff == 0:
        return out_d, out_i
    up = _Uploader(device, d)
    with batch_cache(device, tile_bytes(block, d)) as cache:
        sources = (X,) if norms is None else (X, norms)
        key = None if cache is None else cache.stream_key(sources, block, device, "pairwise")
        for qs in range(0, nq, query_block):
            qe = min(qs + query_block, nq)
            with span("pairwise.query_block", start=qs, rows=qe - qs):
                Qb = up.rows(Q, qs, qe, slot="Q")
                best = (torch.full((qe - qs, k_eff), torch.inf, dtype=torch.float32, device=device),
                        torch.full((qe - qs, k_eff), -1, dtype=torch.int64, device=device))
                for tile in _device_blocks(X, block, up, norms, cache, key):
                    best = _tile_topk_merge(Qb, tile, k_eff, best)
                out_d[qs:qe] = best[0].cpu().numpy()
                out_i[qs:qe] = best[1].cpu().numpy()
    return out_d, out_i


def streaming_norms(X: np.ndarray, device: torch.device, item_block: int = ITEM_BLOCK
                    ) -> np.ndarray:
    """(n,) f32 squared norms of the rows of host X, center_norms_sq of one
    tile at a time on `device` (the streamed kNN fit's norms); nothing is
    kept on the device."""
    n, d = X.shape
    out = np.empty((n,), np.float32)
    if n == 0:
        return out
    block = min(int(item_block), n)
    up = _Uploader(device, d)
    for tile in _device_blocks(X, block, up):
        out[tile.start : tile.start + tile.rows] = tile.norms[: tile.rows].cpu().numpy()
    return out


def _streamed_counts(X: np.ndarray, eps2: float, query_block: int, block: int, up: _Uploader,
                     cache, key) -> np.ndarray:
    """int32 (n,) count of each row's eps-neighbors (self included): one
    sweep a query block, the count kernel on each tile, the counts added."""
    n = X.shape[0]
    counts = np.empty((n,), np.int32)
    for qs in range(0, n, query_block):
        qe = min(qs + query_block, n)
        Qb = up.rows(X, qs, qe, slot="Q")
        acc = torch.zeros((qe - qs,), dtype=torch.int32, device=Qb.device)
        for tile in _device_blocks(X, block, up, None, cache, key):
            acc += fused_count_below(Qb, tile.X, tile.valid, eps2)
        counts[qs:qe] = acc.cpu().numpy()
        counters["dbscan.core_blocks"] += 1
    return counts


def _streamed_min_core_labels(X: np.ndarray, offered: np.ndarray, eps2: float, query_block: int,
                              block: int, up: _Uploader, cache, key) -> np.ndarray:
    """One sweep: for every row the least of `offered` (each row's label
    where it is core, int32 max elsewhere) over its eps-neighbors (int32 max
    where none), the plain min-label scan on each tile, a running amin."""
    n = X.shape[0]
    mins = np.empty((n,), np.int32)
    for qs in range(0, n, query_block):
        qe = min(qs + query_block, n)
        Qb = up.rows(X, qs, qe, slot="Q")
        acc = torch.full((qe - qs,), _BIG, dtype=torch.int32, device=Qb.device)
        for tile in _device_blocks(X, block, up, None, cache, key):
            lab = up.rows(offered, tile.start, tile.start + tile.rows, block, fill=_BIG,
                          slot="labels")
            acc = torch.minimum(acc, _min_labels_against(Qb, tile.X, tile.norms, lab, eps2))
        mins[qs:qe] = acc.cpu().numpy()
    return mins


def streaming_dbscan_fit_predict(
    X: np.ndarray, eps: float, min_samples: int, device: torch.device,
    metric: str = "euclidean", max_rounds: int = 64,
    query_block: int = DBSCAN_QUERY_BLOCK, item_block: int = ITEM_BLOCK,
) -> np.ndarray:
    """DBSCAN labels (int64, noise -1, clusters compacted in first-appearance
    order) of the rows of host X (n, d), the rows staying on the host (module
    header). One device cache spans the call: the tiles the core-mask sweep
    uploads replay in every round."""
    _check_blocks(query_block, item_block)
    X = np.ascontiguousarray(X, dtype=np.float32)
    n, d = X.shape
    if metric == "cosine":
        norms = np.linalg.norm(X, axis=1, keepdims=True)
        if n and float(norms.min()) <= 0.0:
            raise ValueError(
                "Cosine distance is not defined for zero-length vectors; the input "
                "contains an all-zero feature row."
            )
        # one normalized host copy: else every sweep would renormalize each tile
        X = X / np.maximum(norms, 1e-30)
        eps2 = 2.0 * float(eps)
    elif metric == "euclidean":
        eps2 = float(eps) * float(eps)
    else:
        raise ValueError(f"metric must be 'euclidean' or 'cosine', got {metric!r}")
    if n == 0:
        return np.empty((0,), np.int64)
    block = min(int(item_block), n)
    up = _Uploader(device, d)
    with batch_cache(device, tile_bytes(block, d)) as cache:
        key = None if cache is None else cache.stream_key((X,), block, device, "pairwise")
        with span("core_mask"):
            core = _streamed_counts(X, eps2, query_block, block, up, cache, key) >= int(min_samples)
        labels = np.arange(n, dtype=np.int32)
        mins, converged = None, False
        with span("propagate"):
            for _ in range(max_rounds):
                offered = np.where(core, labels, _BIG).astype(np.int32)
                mins = _streamed_min_core_labels(X, offered, eps2, query_block, block, up,
                                                 cache, key)
                new = np.where(core, np.minimum(labels, mins), labels).astype(np.int32)
                new = new[new]
                new = new[new]
                counters["dbscan.rounds"] += 1
                _propagate_labels.rounds += 1
                if np.array_equal(new, labels):
                    converged = True
                    break
                labels = new
        with span("border"):
            # on convergence the last round's minima were taken against these labels
            if not converged:
                offered = np.where(core, labels, _BIG).astype(np.int32)
                mins = _streamed_min_core_labels(X, offered, eps2, query_block, block, up,
                                                 cache, key)
    out = np.full((n,), -1, dtype=np.int64)
    out[core] = labels[core]
    border = (~core) & (mins < _BIG)
    out[border] = mins[border]
    return _compact_labels(out)
