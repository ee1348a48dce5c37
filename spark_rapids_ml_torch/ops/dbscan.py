#
# DBSCAN ops of the PyTorch port (counterpart of the JAX package's ops/dbscan.py;
# reference clustering.py:1018-1092 runs cuML's DBSCANMG):
#   * core points: eps-neighbor count (self included) >= min_samples, through the
#     count kernel (ops/count.py::fused_count_below, csrc/count.cu on the card),
#   * clusters: connected components of the core-core eps-graph, by min-label
#     propagation with pointer jumping; each round is one blocked distance scan
#     (_min_core_neighbor_labels, plain PyTorch: the JAX package runs it in XLA,
#     not Pallas) and two gathers,
#   * border points take the label of their minimum-label core neighbor; noise is
#     -1; labels are compacted to 0..n_clusters-1 in first-appearance order.
#
# The JAX package runs the propagation as one lax.while_loop on the device. Here
# it is a host loop that reads "any label changed" once per round (one scalar
# sync); `_propagate_labels.rounds` counts the rounds run. The border pass reuses
# the last round's scan when the loop converged: that round saw the final labels.
#
# Across the ranks of a process group (`dbscan_fit_predict` with a multi-process
# `part`; the JAX package shards the rows over a mesh, reference DBSCANMG): each
# rank holds its own rows, global rows [layout.offset, + its rows), and no rank
# gathers X. Each rank's shard, padded to the largest rank's rows (invalid rows,
# core False, norm 0; parallel/partitioner.py::Ring), travels the ring of
# Partitioner.ring_shift (rank r sends to r + 1), the way
# ops/knn.py::exact_knn_ring passes item shards:
#   * core mask: this rank's rows are counted against each shard in turn, one
#     count-kernel launch a hop with rows on both sides, the integer counts
#     summed (exact in any order); then one all-gather of the core flags;
#   * each propagation round: this rank's rows scan each shard in turn for their
#     least core-neighbor label (a running amin, exact in any order); the shard's
#     core labels come from the global label vector, which every rank holds.
#     Labels are global row ids, so the hook runs on this rank's rows and the
#     pointer jumping on the global vector after one all-gather of the hooked
#     labels. Every rank then holds the same bits, so "any label changed" needs no
#     collective: every rank stops on the same round, the single process's;
#   * the border pass and the compaction: the same rule on this rank's rows, then
#     one all-gather of every row's label, compacted in global first-appearance
#     order on every rank alike; each rank returns its own rows' labels.
# The ring continues from round to round (a round starts with the shard the last
# hop held), so one round makes P - 1 shifts. Collectives of one transform on P
# ranks with R rounds (converged): P - 1 shifts and 1 all-gather for the core
# mask, P - 1 shifts and 1 all-gather a round, 1 all-gather of the labels; 1 more
# (an all-reduce MAX) under the cosine metric, for the zero-row check that every
# rank must raise together; P - 1 shifts more when max_rounds cut the loop.
#

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

from ..parallel.partitioner import Ring
from ..utils import span
from .count import fused_count_below
from .knn import _block_sq_dists, query_blocks

if TYPE_CHECKING:
    from ..parallel.partition import PartitionDescriptor
    from ..parallel.partitioner import Partitioner

_BIG = np.iinfo(np.int32).max  # "no core neighbor"


def _core_mask(X: torch.Tensor, valid: torch.Tensor, eps2: float, min_samples: int) -> torch.Tensor:
    """Bool mask of core points: valid, with at least min_samples valid
    eps-neighbors, self included."""
    counts = fused_count_below(X, X, valid, eps2)
    return (counts >= min_samples) & valid


def _min_labels_against(
    Q: torch.Tensor, X: torch.Tensor, x2: torch.Tensor, core_labels: torch.Tensor, eps2: float,
    block=None,
) -> torch.Tensor:
    """For every row of Q, the least of `core_labels` (int32 max where a row
    offers none) over the rows of X within eps, by a blocked (query block x
    all of X) scan; x2 is X's squared norms."""
    out = torch.empty((Q.shape[0],), dtype=torch.int32, device=Q.device)
    for sl in query_blocks(Q.shape[0], X.shape[0], block):
        near = _block_sq_dists(Q[sl], X, x2) <= eps2
        out[sl] = torch.where(near, core_labels[None, :], _BIG).amin(dim=1)
    return out


def _min_core_neighbor_labels(
    X: torch.Tensor, labels: torch.Tensor, core: torch.Tensor, eps2: float, block=None
) -> torch.Tensor:
    """For every row, the least label among its CORE eps-neighbors (int32 max
    if none), by a blocked (query block x all rows) scan."""
    x2 = torch.sum(X * X, dim=1)
    core_labels = torch.where(core, labels, _BIG)  # a non-core row offers no label
    return _min_labels_against(X, X, x2, core_labels, eps2, block)


def _hook_and_jump(labels: torch.Tensor, mins: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """Hook: core points take the least neighbor label; then two pointer-jumping
    steps compress label chains (labels index rows)."""
    return _jump(torch.where(core, torch.minimum(labels, mins), labels))


def _jump(labels: torch.Tensor) -> torch.Tensor:
    """Two pointer-jumping steps on a label vector whose labels index it."""
    labels = labels[labels.long()]
    return labels[labels.long()]


def _propagate_labels(
    X: torch.Tensor, core: torch.Tensor, eps2: float, max_rounds: int
) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Min-label propagation until no label changes or max_rounds. Returns
    (labels, the last round's neighbor minima, converged)."""
    labels = torch.arange(X.shape[0], dtype=torch.int32, device=X.device)
    mins = None
    for _ in range(max_rounds):
        mins = _min_core_neighbor_labels(X, labels, core, eps2)
        new = _hook_and_jump(labels, mins, core)
        _propagate_labels.rounds += 1
        changed = bool(torch.any(new != labels))  # the per-round sync
        labels = new
        if not changed:
            return labels, mins, True
    return labels, mins, False


_propagate_labels.rounds = 0


def _border_labels(labels: np.ndarray, core: np.ndarray, valid: np.ndarray,
                   mins: np.ndarray) -> np.ndarray:
    """int64 labels before compaction: a core row its propagated label, a valid
    border row its least core-neighbor label, any other row -1."""
    out = np.full((labels.shape[0],), -1, dtype=np.int64)
    out[core] = labels[core]
    border = (~core) & valid & (mins < _BIG)
    out[border] = mins[border]
    return out


def labels_from_core(
    X: torch.Tensor, valid: torch.Tensor, core: torch.Tensor, eps2: float, max_rounds: int = 64
) -> np.ndarray:
    """int64 labels (noise -1) of every row given the core mask: propagation,
    border assignment and compaction."""
    with span("propagate"):
        labels, mins, converged = _propagate_labels(X, core, eps2, max_rounds)
    with span("border"):
        if not converged:
            mins = _min_core_neighbor_labels(X, labels, core, eps2)
        out = _border_labels(labels.cpu().numpy(), core.cpu().numpy(), valid.cpu().numpy(),
                             mins.cpu().numpy())
    return _compact_labels(out)


def _metric_rows(
    X: torch.Tensor, valid: torch.Tensor, eps: float, metric: str,
    part: Optional["Partitioner"] = None,
) -> Tuple[torch.Tensor, float]:
    """(the rows the euclidean scan runs on, its squared radius). metric='cosine'
    reduces exactly to the euclidean scan on row-normalized data: for unit
    vectors ||a−b||² = 2(1 − cos(a, b)), so cosine distance <= eps is the
    squared-euclidean threshold 2·eps. A zero row under the cosine metric
    raises; under a process group on every rank, when any rank holds one."""
    if metric == "cosine":
        norms = torch.linalg.norm(X, dim=1, keepdim=True)
        min_norm = float(torch.min(torch.where(valid[:, None], norms, torch.inf))) if len(X) else np.inf
        bad = min_norm <= 0.0
        if part is not None and part.is_multiprocess:
            bad = part.any(bad)
        if bad:
            raise ValueError(
                "Cosine distance is not defined for zero-length vectors; the input "
                "contains an all-zero feature row."
            )
        return X / torch.clamp(norms, min=1e-30), 2.0 * float(eps)
    if metric == "euclidean":
        return X, float(eps) * float(eps)
    raise ValueError(f"metric must be 'euclidean' or 'cosine', got {metric!r}")


def dbscan_fit_predict(
    X: torch.Tensor,
    valid: torch.Tensor,
    eps: float,
    min_samples: int,
    max_rounds: int = 64,
    metric: str = "euclidean",
    part: Optional["Partitioner"] = None,
    layout: Optional["PartitionDescriptor"] = None,
) -> np.ndarray:
    """Full DBSCAN labeling of the rows of X with `valid` set; int64 labels,
    noise -1 (invalid rows get -1). Under a multi-process `part` X is this
    rank's rows, global rows [layout.offset, + X's rows) of the group's
    `layout`, and the labeling is of every rank's rows (module header), this
    rank's returned; a collective call, every rank makes it."""
    X, eps2 = _metric_rows(X, valid, eps, metric, part)
    if part is not None and part.is_multiprocess:
        return _dbscan_ring(X, valid, eps2, int(min_samples), max_rounds, part, layout)
    with span("core_mask"):
        core = _core_mask(X, valid, eps2, int(min_samples))
    return labels_from_core(X, valid, core, eps2, max_rounds)


def _ring_min_labels(X: torch.Tensor, ring: Ring, core_labels_g: torch.Tensor, eps2: float
                     ) -> torch.Tensor:
    """For every row of X (this rank's), the least core-neighbor label over the
    shards of every rank, one shard a hop; core_labels_g is the global vector
    of each row's label where it is core, int32 max elsewhere."""
    mins = torch.full((X.shape[0],), _BIG, dtype=torch.int32, device=X.device)
    for owner in ring.hops():
        rows = ring.rows[owner]
        if X.shape[0] and rows:
            Xs, _, x2s = ring.tensors
            offered = torch.full((Xs.shape[0],), _BIG, dtype=torch.int32, device=X.device)
            offered[:rows] = core_labels_g[ring.starts[owner] : ring.starts[owner] + rows]
            mins = torch.minimum(mins, _min_labels_against(X, Xs, x2s, offered, eps2))
    return mins


def _dbscan_ring(
    X: torch.Tensor, valid: torch.Tensor, eps2: float, min_samples: int, max_rounds: int,
    part: "Partitioner", layout: "PartitionDescriptor",
) -> np.ndarray:
    """dbscan_fit_predict across the ranks of `part` (module header): this
    rank's rows' int64 labels."""
    rows = [sz for _, sz in layout.parts_rank_size]
    n, off = X.shape[0], layout.offset
    ring = Ring(part, rows, (X, 0.0), (valid, False), (torch.sum(X * X, dim=1), 0.0))
    with span("core_mask"):
        counts = torch.zeros((n,), dtype=torch.int32, device=X.device)
        for owner in ring.hops():
            if n and rows[owner]:
                counts += fused_count_below(X, *ring.tensors[:2], eps2)
        core = (counts >= min_samples) & valid
    with span("exchange", route="allgather"):
        core_g = part.all_gather_rows(core, rows)
    labels_g = torch.arange(layout.m, dtype=torch.int32, device=X.device)
    converged = False
    with span("propagate"):
        for _ in range(max_rounds):
            mins = _ring_min_labels(X, ring, torch.where(core_g, labels_g, _BIG), eps2)
            mine = labels_g[off : off + n]
            hooked = torch.where(core, torch.minimum(mine, mins), mine)
            with span("exchange", route="allgather"):
                new_g = _jump(part.all_gather_rows(hooked, rows))
            _propagate_labels.rounds += 1
            # the same bits on every rank: every rank stops on this round or none
            changed = bool(torch.any(new_g != labels_g))
            labels_g = new_g
            if not changed:
                converged = True
                break
    with span("border"):
        if not converged:
            mins = _ring_min_labels(X, ring, torch.where(core_g, labels_g, _BIG), eps2)
        out = _border_labels(labels_g[off : off + n].cpu().numpy(), core.cpu().numpy(),
                             valid.cpu().numpy(), mins.cpu().numpy())
        with span("exchange", route="allgather"):
            out_g = part.all_gather_rows(torch.from_numpy(out), rows).numpy()
    return _compact_labels(out_g)[off : off + n]


def _compact_labels(out: np.ndarray) -> np.ndarray:
    """Compact labels to 0..k-1 in first-appearance order (sklearn/cuML
    convention): order cluster representatives by their first row."""
    n = out.shape[0]
    clustered = out >= 0
    if clustered.any():
        uniq, first_idx = np.unique(out[clustered], return_index=True)
        order = np.argsort(np.nonzero(clustered)[0][first_idx])
        rank = np.empty(len(uniq), dtype=np.int64)
        rank[order] = np.arange(len(uniq))
        final = np.full((n,), -1, dtype=np.int64)
        final[clustered] = rank[np.searchsorted(uniq, out[clustered])]
        return final
    return out
