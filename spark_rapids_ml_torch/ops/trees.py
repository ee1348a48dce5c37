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
# The forest JSON (forest_to_json / forest_from_json) and the treelite import
# (forest_from_treelite_json) are the JAX package's, in numpy, copied here: the
# same attributes give the same dump, and the same dump the same arrays.
#
# Out-of-core (`streaming_forest_fit`, the JAX package's streaming_forest_fit):
# X stays on the host and goes through the device in batches, each binned
# there into one resident uint8 (n, d) matrix (a quarter of X's f32 bytes);
# the edges come from a strided row sample, every max(1, n // 200,000)-th
# global row (each rank's part gathered in rank order under a group), through
# the same quantile_bin_edges. The trees then grow by `grow_forest`, the code
# the in-core forest_fit grows with, so the two fits differ only in their
# edges and in how the bins were made. Needs maxBins <= 256.
#

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, List, Optional, Union

import numpy as np
import torch

from ..utils import span
from . import ingest

if TYPE_CHECKING:
    from ..parallel.partition import PartitionDescriptor
    from ..parallel.partitioner import Partitioner
from .histogram import node_bin_histogram
from .selection import top_k_max

BIN_CHUNK_ELEMS = 1 << 28  # elements of X transposed at a time by bin_features
ROUTE_ROWS = 1 << 22  # rows a level routes at a time
EDGE_SAMPLE_ROWS = 200_000  # the streamed fit's edges: about this many strided rows


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
        # leaf rows stay in the left child slot (unreachable at predict); rows
        # go ROUTE_ROWS at a time, which bounds the int64 temporaries
        routed = torch.empty_like(node_id)
        for r0 in range(0, node_id.shape[0], ROUTE_ROWS):
            rows = slice(r0, r0 + ROUTE_ROWS)
            node = node_id[rows].long()
            picked = torch.gather(Xb[rows], 1, best_feat[node][:, None].to(torch.int64))[:, 0]
            go_right = (picked > best_bin[node]) & ~is_leaf_t[node]
            routed[rows] = node_id[rows] * 2 + go_right.to(torch.int32)
        node_id = routed
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


def _check_forest(n_trees: int, max_depth: int) -> None:
    if n_trees < 1:
        raise ValueError(f"numTrees must be >= 1, got {n_trees}")
    if max_depth < 0:
        raise ValueError(f"maxDepth must be >= 0, got {max_depth}")


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
    """Bin once, then grow the forest tree by tree (grow_forest). Under a
    process group `part`, X and raw_stats are this rank's rows, global rows
    [layout.offset, + n) of layout.m, and every rank returns the same forest
    (module header)."""
    _check_forest(n_trees, max_depth)
    with span("bin"):
        edges = quantile_bin_edges(X, max_bins, seed=seed, part=part, layout=layout)
        Xb = bin_features(X, torch.from_numpy(edges).to(X.device))
    return grow_forest(
        Xb, raw_stats, edges, n_trees, max_depth, max_bins, impurity, feature_subset,
        min_instances, min_info_gain, subsampling_rate, bootstrap, seed, part, layout,
    )


def grow_forest(
    Xb: torch.Tensor,  # (n, d) uint8 or int32 bins on the device the forest grows on
    raw_stats: torch.Tensor,  # (n, s) unweighted per-row stats (sample weight included)
    edges: np.ndarray,  # (d, max_bins-1) f32 bin edges on the host
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
    """The growth loop over rows already binned, shared by the in-core
    forest_fit and the streamed streaming_forest_fit (the JAX package's
    `_grow_forest`): trees differ only in their bootstrap weights and
    feature-subset draws. Returns host arrays stacked over trees, and the bin
    edges. Under a process group Xb and raw_stats are this rank's rows,
    global rows [layout.offset, + n) of layout.m (module header)."""
    n = Xb.shape[0]
    total = n if layout is None else layout.m
    lo = 0 if layout is None else layout.offset
    edges_t = torch.from_numpy(edges).to(Xb.device)
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
            values = raw_stats * torch.from_numpy(w_tree).to(Xb.device)[:, None]
        gen = torch.Generator(device=Xb.device)
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


def strided_sample(X: np.ndarray, part: Optional["Partitioner"] = None,
                   layout: Optional["PartitionDescriptor"] = None) -> torch.Tensor:
    """The streamed fit's edge sample, a CPU f32 tensor: the rows X[::step]
    of the global rows, step = max(1, n // EDGE_SAMPLE_ROWS) (rows are not
    assumed shuffled). Under a process group X is this rank's rows, global
    rows [layout.offset, + its rows) of layout.m; each rank takes the sampled
    rows it owns, and one all-gather joins them in rank order on every rank
    (a collective call)."""
    total = X.shape[0] if layout is None else layout.m
    step = max(1, total // EDGE_SAMPLE_ROWS)

    def first(start: int) -> int:  # a rank's first sampled row, local
        return (-start) % step

    off = 0 if layout is None else layout.offset
    mine = ingest.host_tensor(np.ascontiguousarray(X[first(off) :: step], dtype=np.float32))
    if part is None or not part.is_multiprocess:
        return mine
    starts = np.cumsum([0] + [r for _, r in layout.parts_rank_size])
    sizes = [len(range(first(int(a)), int(b - a), step)) for a, b in zip(starts[:-1], starts[1:])]
    return part.all_gather_rows(mine.reshape(-1, layout.n), sizes)


def streaming_forest_fit(
    X: np.ndarray,  # (n, d) host features; they never lie whole on the device
    raw_stats: torch.Tensor,  # (n, s) unweighted per-row stats on `device`
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
    batch_rows: int,
    device: torch.device,
    part: Optional["Partitioner"] = None,
    layout: Optional["PartitionDescriptor"] = None,
) -> Dict[str, np.ndarray]:
    """The out-of-core forest fit (the JAX package's streaming_forest_fit):
    the edges of the strided sample (strided_sample) through
    quantile_bin_edges, whose own 200,000-row draw applies to that sample;
    X streamed through the device in batches of `batch_rows` rows
    (ops/streaming.py), each binned there into one resident uint8 (n, d)
    matrix; then grow_forest, the in-core fit's growth. Resident on the
    device: the bins, the stats and the batches in flight. Under a process
    group, as forest_fit."""
    from .streaming import _Stream

    _check_forest(n_trees, max_depth)
    if max_bins > 256:
        raise ValueError(f"the streamed forest bins to uint8: maxBins must be <= 256, got {max_bins}")
    n, d = X.shape
    with span("bin"):
        edges = quantile_bin_edges(strided_sample(X, part, layout), max_bins, seed=seed)
        edges_t = torch.from_numpy(edges).to(device)
        Xb = torch.empty((n, d), dtype=torch.uint8, device=device)
        s = 0
        for batch in _Stream(X, None, None, batch_rows, device, np.float32, "forest").batches(None):
            Xb[s : s + batch.rows] = bin_features(batch.X[: batch.rows], edges_t)
            s += batch.rows
    return grow_forest(
        Xb, raw_stats, edges, n_trees, max_depth, max_bins, impurity, feature_subset,
        min_instances, min_info_gain, subsampling_rate, bootstrap, seed, part, layout,
    )


# ---------------------------------------------------------------------------
# Forest JSON and treelite import (numpy; the JAX package's ops/trees.py)
# ---------------------------------------------------------------------------


def forest_to_json(model_attrs: Dict[str, np.ndarray], is_classification: bool) -> List[Dict]:
    """Portable nested-dict dump of the forest — the role of the reference's
    treelite JSON dump for Spark-tree interop (reference tree.py:534-559,
    utils.py:585-809)."""
    feature = model_attrs["feature"]
    threshold = model_attrs["threshold"]
    is_leaf = model_attrs["is_leaf"]
    value = model_attrs["value"]

    def node(tree_idx: int, p: int) -> Dict:
        if is_leaf[tree_idx, p] or feature[tree_idx, p] < 0 or 2 * p >= feature.shape[1]:
            payload = value[tree_idx, p].tolist()
            return (
                {"leaf_value": payload}
                if not is_classification
                else {"leaf_class_probs": payload}
            )
        return {
            "split_feature": int(feature[tree_idx, p]),
            "threshold": float(threshold[tree_idx, p]),
            "default_left": True,
            "left_child": node(tree_idx, 2 * p),
            "right_child": node(tree_idx, 2 * p + 1),
        }

    return [
        {"tree_id": i, "root": node(i, 1)} for i in range(feature.shape[0])
    ]


def forest_from_json(
    trees_json: List[Dict], n_features: int, is_classification: bool
) -> Dict[str, np.ndarray]:
    """Inverse of forest_to_json: rebuild the heap-layout forest arrays from the
    portable nested-dict dump, so forests exported by this framework (or translated
    from treelite/cuML dumps into the same shape) can be imported as models — the
    import half of the reference's treelite interop (reference tree.py:439-449)."""
    leaf_key = "leaf_class_probs" if is_classification else "leaf_value"

    def depth_of(node: Dict) -> int:
        if leaf_key in node or "left_child" not in node:
            return 0
        return 1 + max(depth_of(node["left_child"]), depth_of(node["right_child"]))

    if not trees_json:
        raise ValueError("empty forest JSON")
    roots = [t["root"] for t in trees_json]
    max_depth = max(depth_of(r) for r in roots)
    if max_depth > 20:
        # the heap layout allocates 2^(depth+1) slots per tree: one depth-25
        # branch in an imported (e.g. cuML-trained) forest would inflate every
        # array by 2^26 slots — fail with the number instead of a MemoryError
        raise ValueError(
            f"forest depth {max_depth} exceeds the dense-heap import limit (20); "
            f"re-train/dump with a bounded max_depth to import"
        )
    v_dims = set()

    def leaf_dim(node: Dict) -> None:
        if leaf_key in node:
            v_dims.add(len(node[leaf_key]))
        else:
            leaf_dim(node["left_child"])
            leaf_dim(node["right_child"])

    for r in roots:
        leaf_dim(r)
    if len(v_dims) != 1:
        raise ValueError(f"inconsistent leaf payload dims: {sorted(v_dims)}")
    v_dim = v_dims.pop()

    n_trees = len(roots)
    n_slots = 2 ** (max_depth + 1)
    feature = np.full((n_trees, n_slots), -1, np.int32)
    threshold = np.zeros((n_trees, n_slots), np.float32)
    is_leaf = np.zeros((n_trees, n_slots), bool)
    value = np.zeros((n_trees, n_slots, v_dim), np.float32)

    def fill(tree_idx: int, node: Dict, p: int) -> None:
        if leaf_key in node:
            is_leaf[tree_idx, p] = True
            value[tree_idx, p] = np.asarray(node[leaf_key], np.float32)
            return
        f = int(node["split_feature"])
        if not 0 <= f < n_features:
            raise ValueError(f"split_feature {f} out of range for d={n_features}")
        feature[tree_idx, p] = f
        threshold[tree_idx, p] = float(node["threshold"])
        fill(tree_idx, node["left_child"], 2 * p)
        fill(tree_idx, node["right_child"], 2 * p + 1)

    for i, r in enumerate(roots):
        fill(i, r, 1)
    return {
        "feature": feature,
        "threshold": threshold,
        "is_leaf": is_leaf,
        "value": value,
        "bin_edges": np.zeros((n_features, 1), np.float32),
    }


def _prev_f32_ftz(t: float) -> float:
    """Largest float32 strictly below t under XLA's flush-to-zero semantics,
    as the JAX package computes it, so that both packages import a dump to the
    same thresholds.

    nextafter(0.0, -inf) is a denormal, and XLA flushes denormals to +-0.0 — the
    nudge silently vanishes and equality routes the wrong way (caught by driving
    a '<' split at threshold 0.0). Denormal results are therefore snapped to the
    nearest FTZ-representable neighbor: -tiny below zero, 0.0 for positive
    denormals (consistent with denormal INPUTS also flushing to zero). The
    port's predict does not flush denormal inputs: a denormal input in
    (-tiny, 0) at a '<' split of threshold 0 goes right in the port."""
    p = np.nextafter(np.float32(t), np.float32(-np.inf))
    tiny = np.finfo(np.float32).tiny
    if p != 0.0 and abs(p) < tiny:
        p = np.float32(-tiny) if p < 0 else np.float32(0.0)
    return float(p)


def _treelite_tree_to_nested(tree: Dict, is_classification: bool) -> Dict:
    """One treelite-JSON tree (flat `nodes` list keyed by node_id — the schema the
    reference translates at utils.py:700-809) -> this module's nested dict.

    Routing semantics: this framework's predict goes LEFT iff x[f] <= threshold.
    Treelite records a comparison_op per split; for "<" the equality case must go
    right, so the threshold is nudged to the previous float32 (x <= prev(t) iff
    x < t for float32 inputs). "<=" imports unchanged.

    Missing values: predict routes NaN LEFT (NaN > t is false), which matches
    treelite's default_left=True. Nodes dumped with default_left=False would
    misroute NaN features — flagged with a warning on import since this engine
    has no per-node missing-direction bit.
    """
    nodes = {n["node_id"]: n for n in tree["nodes"]}
    leaf_key = "leaf_class_probs" if is_classification else "leaf_value"
    if any(
        n.get("default_left") is False
        for n in tree["nodes"]
        if "left_child" in n
    ):
        import warnings

        warnings.warn(
            "treelite dump contains default_left=False splits; this engine "
            "routes NaN/missing features LEFT, so predictions on rows with "
            "missing values may differ from the source model",
            stacklevel=3,
        )

    def conv(node_id: int) -> Dict:
        n = nodes[node_id]
        if "leaf_value" in n or "leaf_vector" in n:
            v = n.get("leaf_vector", n.get("leaf_value"))
            payload = list(v) if isinstance(v, (list, tuple)) else [float(v)]
            if is_classification and len(payload) < 2:
                raise ValueError(
                    "classification import needs per-class leaf_vector "
                    "probabilities (cuML RF dumps these); scalar leaves are "
                    "margin/regression outputs"
                )
            return {leaf_key: payload}
        op = n.get("comparison_op", "<=")
        thr = float(n["threshold"])
        if op == "<":
            thr = _prev_f32_ftz(thr)
        elif op != "<=":
            raise ValueError(f"unsupported treelite comparison_op {op!r}")
        return {
            "split_feature": int(n["split_feature_id"]),
            "threshold": thr,
            "default_left": bool(n.get("default_left", True)),
            "left_child": conv(n["left_child"]),
            "right_child": conv(n["right_child"]),
        }

    return {"root": conv(int(tree.get("root_id", 0)))}


def forest_from_treelite_json(
    model_json: Union[Dict, List[Dict]],
    is_classification: bool,
    n_features: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Import a treelite JSON dump (cuML `dump_as_json`, what the reference's
    models carry as `treelite_model` JSON, reference tree.py:534-559) into the
    heap-layout forest arrays. Accepts either the full model dict (with `trees`
    and `num_feature`) or a bare list of tree dicts (then n_features is required)."""
    if isinstance(model_json, dict):
        trees = model_json["trees"]
        if n_features is None:
            n_features = int(model_json.get("num_feature", 0)) or None
    else:
        trees = model_json
    if n_features is None:
        raise ValueError(
            "n_features is required when the dump carries no num_feature"
        )
    nested = [
        {"tree_id": i, **_treelite_tree_to_nested(t, is_classification)}
        for i, t in enumerate(trees)
    ]
    return forest_from_json(nested, int(n_features), is_classification)
