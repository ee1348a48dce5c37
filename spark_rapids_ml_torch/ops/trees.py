#
# Histogram-based random-forest builder of the PyTorch port (counterpart of the
# in-core half of the JAX package's ops/trees.py):
#   * features are quantile-binned once (max_bins buckets, edges from a host
#     row sample), and trees only ever touch bin ids: uint8 up to 256 bins (a
#     quarter of int32's bytes for the histogram kernel to read), int32 above;
#   * trees grow level-wise over a perfect binary heap (level t has 2^t node
#     slots); per level one node x bin histogram (ops/histogram.py, the CUDA
#     kernel of csrc/hist.cu on the card) gives every split's statistics;
#   * split selection is a cumulative sum and an argmax over the histogram, and
#     the children's statistics are carried from the winning split, so each
#     level reads the data once;
#   * prediction walks the heap with gathers, one tree at a time.
# Impurities: gini and entropy (stats = per-class weighted counts) and variance
# (stats = [w, w y, w y^2]), with Spark's weighted information gain,
# minInstancesPerNode and minInfoGain.
#
# The arithmetic is the JAX package's, line for line, so that the same inputs
# grow the same trees: the bootstrap weights are the same numpy draws, and a
# node's feature subset takes the k largest of uniform scores. Those scores come
# from a torch.Generator seeded per tree as the JAX package seeds its PRNG key,
# through `_feature_scores`, the one place they are drawn (tests replay
# jax.random's scores there). Differences, on purpose:
#   * X is binned on the device (torch.searchsorted, side="left": bin = number
#     of edges < x, the JAX package's native.py semantics), feature-chunked;
#   * rows are routed by a row gather of the chosen feature's bin (the JAX
#     package's exact route; its bf16 one-hot matmul route exists only because
#     a lane gather is slow on the TPU);
#   * a tree's levels run eagerly on the device with no host read inside a tree.
#
# Across the ranks of a process group (parallel/partitioner.py) each rank holds
# its own rows and every rank grows the same forest, the counterpart of the
# JAX package's sharded fit (`forest_fit` with shard_fn and mesh, whose
# `_shard_psum` adds the level histograms over the devices):
#   * edges: the single-process row sample, default_rng(seed).choice(n,
#     sample_limit) over the global n when n > sample_limit, else every row;
#     each rank takes the sampled rows it owns, one all-gather collects them,
#     and np.quantile sorts each column, so the edges are the single-process
#     edges bit for bit;
#   * bootstrap: each rank draws the single-process per-tree vector over the
#     global n and keeps its slice [offset, offset + rows). Every rank needs
#     its generator in the same state for the next tree, so each draws all of
#     n: the draws' host time does not fall with the rank count;
#   * each level: each rank builds its node x bin histogram on its own rows
#     with the kernel, and one all-reduce SUM of the (width, d, nbins, s) tile
#     adds them. Every rank then holds the same bits, so split selection, the
#     heap writes and the carried child stats are the same on every rank;
#     each rank routes only its own rows;
#   * the feature-subset scores come from the per-tree torch.Generator seeded
#     as in one process; ranks on one device type draw the same scores.
# The root's stats are level 0's histogram summed over feature 0's bins in
# f64 and rounded once to f32, in one process and across ranks alike (the JAX
# package sums the rows in f32), so they do not depend on how the rows are
# split. On integer stats (a classifier under unit or bootstrap weights) the
# forest is then the single-process forest bit for bit while every bin sum of
# a level histogram stays below 2^24, where f32 adds integers exactly in any
# order (at 50M rows and 32 quantile bins a root bin holds about 1.6M). On
# real-valued stats the sums are added in another order.
#
# Not ported: the streamed (uint8) fit, the forest JSON and treelite
# import/export.
#

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np
import torch

from ..utils import span

if TYPE_CHECKING:
    from ..parallel.partition import PartitionDescriptor
    from ..parallel.partitioner import Partitioner
from .histogram import node_bin_histogram
from .selection import top_k_max

BIN_CHUNK_ELEMS = 1 << 28  # elements of X transposed at a time by bin_features


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------


def quantile_bin_edges(
    X: torch.Tensor, max_bins: int, sample_limit: int = 200_000, seed: int = 0,
    part: Optional["Partitioner"] = None, layout: Optional["PartitionDescriptor"] = None,
) -> np.ndarray:
    """Per-feature quantile thresholds, (d, max_bins-1) f32 on the host. Bin b
    holds x <= edges[b] (last bin open). Computed on a host copy of a row sample
    of X (on any device): the JAX package's sample, the same rows for the same
    seed, and its numpy quantiles. Under a process group X is this rank's
    rows, global rows [layout.offset, + n) of layout.m, and the sample is the
    single-process one, gathered from the ranks that own its rows (module
    header): a collective call."""
    sizes = [X.shape[0]] if layout is None else [r for _, r in layout.parts_rank_size]
    rank = 0 if layout is None else layout.rank
    starts = np.cumsum([0] + sizes)
    if starts[-1] > sample_limit:
        idx = np.random.default_rng(seed).choice(int(starts[-1]), sample_limit, replace=False)
        sizes = [int(((idx >= a) & (idx < b)).sum()) for a, b in zip(starts[:-1], starts[1:])]
        mine = idx[(idx >= starts[rank]) & (idx < starts[rank + 1])] - starts[rank]
        X = X[torch.from_numpy(mine).to(X.device)]
    if part is not None:
        X = part.all_gather_rows(X, sizes)
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    return np.quantile(X.cpu().numpy(), qs, axis=0).T.astype(np.float32)  # (d, max_bins-1)


def bin_features(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Bins (n, d) on X's device: bin = number of edges < x, in
    [0, max_bins-1], with max_bins = edges.shape[1] + 1; uint8 when
    max_bins <= 256 (as the JAX package's streamed fit bins), else int32. X is
    compared in f32; a few features at a time are transposed so searchsorted
    runs along each feature's edges."""
    n, d = X.shape
    edges = edges.to(device=X.device, dtype=torch.float32).contiguous()
    dtype = torch.uint8 if edges.shape[1] + 1 <= 256 else torch.int32
    Xb = torch.empty((n, d), dtype=dtype, device=X.device)
    step = max(1, BIN_CHUNK_ELEMS // max(n, 1))
    for j0 in range(0, d, step):
        j1 = min(d, j0 + step)
        cols = X[:, j0:j1].T.to(torch.float32).contiguous()  # (dj, n)
        Xb[:, j0:j1] = torch.searchsorted(
            edges[j0:j1], cols, side="left", out_int32=True
        ).T
    return Xb


# ---------------------------------------------------------------------------
# Impurity algebra on stat vectors
# ---------------------------------------------------------------------------


def _stat_weight(stats: torch.Tensor, impurity: str) -> torch.Tensor:
    if impurity == "variance":
        return stats[..., 0]
    return torch.sum(stats, dim=-1)


def _impurity_times_w(stats: torch.Tensor, impurity: str) -> torch.Tensor:
    """w * impurity(stats), the additive form the gain is computed from."""
    w = _stat_weight(stats, impurity)
    safe_w = torch.clamp(w, min=1e-12)
    if impurity == "variance":
        wy, wyy = stats[..., 1], stats[..., 2]
        return wyy - wy * wy / safe_w
    p_sq_sum = torch.sum(stats * stats, dim=-1) / safe_w
    if impurity == "gini":
        return w - p_sq_sum
    # entropy
    p = stats / safe_w[..., None]
    plogp = torch.where(p > 0, p * torch.log2(torch.clamp(p, min=1e-12)), 0.0)
    return w * -torch.sum(plogp, dim=-1)


def _leaf_value(stats: torch.Tensor, impurity: str) -> torch.Tensor:
    """Leaf payload: class distribution (classification) or [mean] (regression)."""
    if impurity == "variance":
        w = torch.clamp(stats[..., 0], min=1e-12)
        return (stats[..., 1] / w)[..., None]
    w = torch.clamp(torch.sum(stats, dim=-1, keepdim=True), min=1e-12)
    return stats / w


# ---------------------------------------------------------------------------
# Level-wise builder
# ---------------------------------------------------------------------------


def _feature_scores(
    generator: torch.Generator, width: int, d: int, device: torch.device
) -> torch.Tensor:
    """(width, d) uniform [0, 1) f32 scores of one level; each node splits on
    the features of its k largest."""
    return torch.rand((width, d), generator=generator, device=device)


def _split_gains(
    cum: torch.Tensor,
    T: torch.Tensor,
    impurity: str,
    k_features: int,
    min_instances: int,
    generator: torch.Generator,
) -> torch.Tensor:
    """(width, d, nbins - 1) gain of every split of a level, from the
    histogram's cumulative sums over bins `cum` (width, d, nbins, s) and the
    nodes' stats T (width, s): -inf where a child would hold fewer than
    min_instances or the feature is outside the node's subset."""
    width, d = cum.shape[:2]
    L = cum[:, :, :-1, :]  # split at bin 0..b-2
    R = T[:, None, None, :] - L

    wT = _stat_weight(T, impurity)  # (w,)
    wL = _stat_weight(L, impurity)  # (w, d, b-1)
    wR = _stat_weight(R, impurity)
    gain = (
        _impurity_times_w(T, impurity)[:, None, None]
        - _impurity_times_w(L, impurity)
        - _impurity_times_w(R, impurity)
    ) / torch.clamp(wT, min=1e-12)[:, None, None]

    valid = (wL >= min_instances) & (wR >= min_instances)
    if k_features < d:
        scores = _feature_scores(generator, width, d, cum.device)
        kth = top_k_max(scores, k_features)[0][:, -1]
        valid = valid & (scores >= kth[:, None])[:, :, None]
    return torch.where(valid, gain, -math.inf)


def _level_step(
    state: List[torch.Tensor],
    Xb: torch.Tensor,
    values: torch.Tensor,
    edges: torch.Tensor,
    t: int,
    nbins: int,
    impurity: str,
    k_features: int,
    min_instances: int,
    min_info_gain: float,
    generator: torch.Generator,
    part: Optional["Partitioner"] = None,
) -> List[torch.Tensor]:
    """One tree level (width = 2**t): histogram, split selection, heap writes,
    row routing and the children's stats. The heap arrays are written in place.
    Under a process group the histogram is added across the ranks. Level 0
    takes the root's stats T from it (module header)."""
    feat_arr, thr_arr, leaf_arr, val_arr, gain_arr, wgt_arr, node_id, T = state
    s = values.shape[1]
    width = 2**t
    with span("histogram"):
        hist = node_bin_histogram(Xb, node_id, values, width, nbins)  # (w, d, b, s)
    if part is not None and part.is_multiprocess:
        with span("exchange"):
            (hist,) = part.all_reduce_sum(hist)
    if t == 0:
        T = torch.sum(hist[:, 0], dim=1, dtype=torch.float64).float()  # (1, s)
    with span("split"):
        cum = torch.cumsum(hist, dim=2)
        gain = _split_gains(cum, T, impurity, k_features, min_instances, generator)
        wT = _stat_weight(T, impurity)  # (w,)

        flat = gain.reshape(width, -1)
        best = torch.argmax(flat, dim=1)  # the first maximum, as jnp.argmax
        best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
        best_feat = best // (nbins - 1)
        best_bin = best % (nbins - 1)

        is_leaf_t = ~(best_gain > min_info_gain)  # also catches all -inf / NaN
        slots = slice(width, 2 * width)
        feat_arr[slots] = torch.where(is_leaf_t, -1, best_feat).to(torch.int32)
        thr_arr[slots] = edges[best_feat, best_bin]
        leaf_arr[slots] = is_leaf_t
        val_arr[slots] = _leaf_value(T, impurity)
        gain_arr[slots] = torch.where(is_leaf_t, 0.0, torch.clamp(best_gain, min=0.0))
        wgt_arr[slots] = wT

        # children's stats carried from the winning split
        Lbest = cum[torch.arange(width, device=cum.device), best_feat, best_bin, :]  # (w, s)
        T = torch.stack([Lbest, T - Lbest], dim=1).reshape(2 * width, s)

    with span("route"):
        # leaf rows stay in the left child slot (unreachable at predict)
        node = node_id.long()
        picked = torch.gather(Xb, 1, best_feat[node][:, None].to(torch.int64))[:, 0]
        go_right = (picked > best_bin[node]) & ~is_leaf_t[node]
        node_id = node_id * 2 + go_right.to(torch.int32)
    return [feat_arr, thr_arr, leaf_arr, val_arr, gain_arr, wgt_arr, node_id, T]


def build_tree(
    Xb: torch.Tensor,  # (n, d) uint8 or int32 bins
    values: torch.Tensor,  # (n, s) per-row stats already weighted (0 rows add 0)
    edges: torch.Tensor,  # (d, nbins-1) real thresholds, on Xb's device
    generator: torch.Generator,  # per-tree feature-subset draws
    max_depth: int,
    nbins: int,
    impurity: str,
    k_features: int,
    min_instances: int,
    min_info_gain: float,
    part: Optional["Partitioner"] = None,
) -> Dict[str, torch.Tensor]:
    """Grow one tree; returns heap arrays of 2^(max_depth+1) slots on the
    device: feature (int32, -1 for a leaf), threshold (f32), is_leaf (bool),
    value (slots, v), gain and node_weight (f32). Under a process group
    `part`, Xb and values are this rank's rows, and every rank returns the
    same tree (a collective call: one all-reduce a level)."""
    n = Xb.shape[0]
    s = values.shape[1]
    n_slots = 2 ** (max_depth + 1)
    v_dim = 1 if impurity == "variance" else s
    dev = Xb.device
    state = [
        torch.full((n_slots,), -1, dtype=torch.int32, device=dev),  # feature (-1 = leaf)
        torch.zeros((n_slots,), dtype=torch.float32, device=dev),  # threshold
        torch.zeros((n_slots,), dtype=torch.bool, device=dev),  # is_leaf
        torch.zeros((n_slots, v_dim), dtype=torch.float32, device=dev),  # value
        # per-node split gain and weighted row count: the inputs to
        # impurity-based featureImportances (Spark TreeEnsembleModel semantics)
        torch.zeros((n_slots,), dtype=torch.float32, device=dev),  # gain
        torch.zeros((n_slots,), dtype=torch.float32, device=dev),  # node weight
        torch.zeros((n,), dtype=torch.int32, device=dev),  # node_id
        None,  # (1, s) root stats, from level 0's histogram
    ]
    if max_depth == 0:
        # no level: the rows' f64 sum, rounded once to f32 as level 0 rounds it
        T = torch.sum(values, dim=0, dtype=torch.float64)[None, :]
        if part is not None and part.is_multiprocess:
            with span("exchange"):
                (T,) = part.all_reduce_sum(T)
        state[7] = T.float()
    for t in range(max_depth):
        state = _level_step(
            state, Xb, values, edges, t, nbins, impurity, k_features, min_instances,
            min_info_gain, generator, part,
        )
    feat_arr, thr_arr, leaf_arr, val_arr, gain_arr, wgt_arr, _, T = state

    # deepest level: all leaves
    slots = slice(2**max_depth, 2 ** (max_depth + 1))
    leaf_arr[slots] = True
    val_arr[slots] = _leaf_value(T, impurity)
    wgt_arr[slots] = _stat_weight(T, impurity)
    return {
        "feature": feat_arr,
        "threshold": thr_arr,
        "is_leaf": leaf_arr,
        "value": val_arr,
        "gain": gain_arr,
        "node_weight": wgt_arr,
    }


def predict_forest(
    X: torch.Tensor,  # (n, d) raw features
    feature: torch.Tensor,  # (n_trees, n_slots)
    threshold: torch.Tensor,
    is_leaf: torch.Tensor,
    value: torch.Tensor,  # (n_trees, n_slots, v)
    max_depth: int,
) -> torch.Tensor:
    """Mean of the per-tree leaf payloads, (n, v) f32: the trees' sum in tree
    order times 1/n_trees, as the JAX package's mean. A row goes right where
    x[f] > threshold; NaN compares False and goes left."""
    X = X.to(torch.float32)
    n = X.shape[0]
    total: Optional[torch.Tensor] = None
    for i in range(feature.shape[0]):
        feat_t, thr_t, leaf_t = feature[i], threshold[i], is_leaf[i]
        p = torch.ones((n,), dtype=torch.int64, device=X.device)
        for _ in range(max_depth):
            f = torch.clamp(feat_t[p], min=0).to(torch.int64)
            picked = torch.gather(X, 1, f[:, None])[:, 0]
            go_right = picked > thr_t[p]
            p = torch.where(leaf_t[p], p, p * 2 + go_right.to(torch.int64))
        v = value[i][p]
        total = v if total is None else total + v
    return total * (1.0 / feature.shape[0])


# ---------------------------------------------------------------------------
# Forest driver
# ---------------------------------------------------------------------------


def resolve_feature_subset(strategy: str, d: int, is_classification: bool) -> int:
    """Spark featureSubsetStrategy resolution (auto/all/sqrt/log2/onethird/number)."""
    s = str(strategy)
    if s == "auto":
        return max(1, int(math.sqrt(d))) if is_classification else max(1, d // 3)
    if s == "all":
        return d
    if s == "sqrt":
        return max(1, int(math.sqrt(d)))
    if s == "log2":
        return max(1, int(math.log2(d)))
    if s == "onethird":
        return max(1, d // 3)
    try:
        val = float(s)
        if val.is_integer() and val >= 1:
            return min(d, int(val))
        if 0 < val <= 1:
            return max(1, int(val * d))
    except ValueError:
        pass
    raise ValueError(f"Unsupported featureSubsetStrategy: {strategy}")


def forest_fit(
    X: torch.Tensor,  # (n, d) features on the device the forest grows on
    raw_stats: torch.Tensor,  # (n, s) unweighted per-row stats (sample weight included)
    n_trees: int,
    max_depth: int,
    max_bins: int,
    impurity: str,
    feature_subset: int,
    min_instances: int,
    min_info_gain: float,
    subsampling_rate: float,
    bootstrap: bool,
    seed: int,
    part: Optional["Partitioner"] = None,
    layout: Optional["PartitionDescriptor"] = None,
) -> Dict[str, np.ndarray]:
    """Bin once, then grow the forest tree by tree; trees differ only in their
    bootstrap weights and feature-subset draws. Returns host arrays stacked over
    trees, and the bin edges. Under a process group `part`, X and raw_stats
    are this rank's rows, global rows [layout.offset, + n) of layout.m, and
    every rank returns the same forest (module header)."""
    if n_trees < 1:
        raise ValueError(f"numTrees must be >= 1, got {n_trees}")
    if max_depth < 0:
        raise ValueError(f"maxDepth must be >= 0, got {max_depth}")
    n = X.shape[0]
    total = n if layout is None else layout.m
    lo = 0 if layout is None else layout.offset
    with span("bin"):
        edges = quantile_bin_edges(X, max_bins, seed=seed, part=part, layout=layout)
        edges_t = torch.from_numpy(edges).to(X.device)
        Xb = bin_features(X, edges_t)
    rng = np.random.default_rng(seed & 0x7FFFFFFF)
    trees: List[Dict[str, np.ndarray]] = []
    for i in range(n_trees):
        with span("bootstrap"):
            # the draws over all the group's rows, of which this rank keeps its own
            if bootstrap:
                w_tree = rng.poisson(subsampling_rate, size=total).astype(np.float32)
            elif subsampling_rate < 1.0:
                w_tree = (rng.random(total) < subsampling_rate).astype(np.float32)
            else:
                w_tree = np.ones((total,), np.float32)
            w_tree = w_tree[lo : lo + n]
            values = raw_stats * torch.from_numpy(w_tree).to(X.device)[:, None]
        gen = torch.Generator(device=X.device)
        gen.manual_seed((seed + 7919 * i) & 0x7FFFFFFF)
        tree = build_tree(
            Xb, values, edges_t, gen, max_depth=max_depth, nbins=max_bins,
            impurity=impurity, k_features=feature_subset, min_instances=min_instances,
            min_info_gain=min_info_gain, part=part,
        )
        trees.append({k: v.cpu().numpy() for k, v in tree.items()})
        del values

    out = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    out["bin_edges"] = edges
    return out
