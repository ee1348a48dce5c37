"""PyTorch port, the forest builder (spark_rapids_ml_torch/ops/trees.py) against
the JAX package's ops/trees.py on the CPU, on the same numpy inputs.

The JAX side grows its trees through its own non-Pallas histogram (the route
its tests take on the CPU). Feature subsets: the port draws its per-level
scores through `_feature_scores`; the tests replay there the jax.random scores
the JAX package draws for the same seed, so forests with a feature subset
compare exactly too.

Tolerances: gini forests and every classifier heap array are exact (all the
histogram sums are integers below 2^24, and the split arithmetic is the same
f32 arithmetic). Entropy's structure (features, thresholds, leaves, values,
weights) is exact, but XLA's CPU log differs from torch's in the last bit of
some 14% of f32 inputs, so entropy gains are held within rtol 1e-6, atol 1e-6
(a few f32 ulps of an entropy of order 1).
Variance: the w y and w y^2 sums are not integers and are taken in another
order, so its histograms, gains and predictions are held within rtol 1e-5 and
its structure is checked on data with no near-tie splits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import selection as jax_selection
from spark_rapids_ml_tpu.ops import trees as jax_trees
from spark_rapids_ml_torch.ops import selection, trees

HEAP = ("feature", "threshold", "is_leaf", "value", "gain", "node_weight")


def _class_data(n=1500, d=6, n_classes=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 1] + rng.normal(0, 0.5, n)) > 0).astype(np.int64)
    if n_classes == 3:
        y = y + (X[:, 2] > 0.8)
    stats = np.zeros((n, n_classes), np.float32)
    stats[np.arange(n), y] = rng.poisson(1.0, n).astype(np.float32)  # bootstrap-like weights
    return X, stats


def _jax_scores(seed, n_trees, depth, d):
    """The per-level feature scores the JAX package draws: tree i's key from
    (seed + 7919 i) & 0x7FFFFFFF, one split per level."""
    out = []
    for i in range(n_trees):
        key = jax.random.PRNGKey((seed + 7919 * i) & 0x7FFFFFFF)
        for t in range(depth):
            key, sub = jax.random.split(key)
            out.append(np.array(jax.random.uniform(sub, (2**t, d))))
    return out


@pytest.fixture
def replay_scores(monkeypatch):
    def install(seed, n_trees, depth, d):
        scores = iter(_jax_scores(seed, n_trees, depth, d))
        monkeypatch.setattr(
            trees, "_feature_scores",
            lambda gen, width, dd, device: torch.from_numpy(next(scores)).to(device),
        )
    return install


def _assert_heap(got, want, impurity):
    for key in HEAP:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key == "gain" and impurity == "entropy":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=key)
        elif impurity == "variance" and key in ("value", "gain", "node_weight"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


# ------------------------------------------------------------------ binning


@pytest.mark.parametrize("limit", [200_000, 1000])  # the whole matrix, and a row sample
def test_quantile_bin_edges_match(limit):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(5000, 7)).astype(np.float32)
    X[:, 3] = np.round(X[:, 3])  # heavy duplicates: repeated edges
    want = jax_trees.quantile_bin_edges(X, 16, sample_limit=limit, seed=4)
    got = trees.quantile_bin_edges(torch.from_numpy(X), 16, limit, seed=4)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_bin_features_match_with_values_on_edges_and_duplicate_edges(monkeypatch):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(3000, 5)).astype(np.float32)
    X[:, 1] = np.round(X[:, 1])  # duplicate edges
    edges = jax_trees.quantile_bin_edges(X, 32)
    X[:31, 0] = edges[0]  # values equal to edges
    X[40:70, 2] = edges[2, :30]
    X[70, :] = -np.inf
    X[71, :] = np.inf
    want = jax_trees.bin_features(X, edges)
    got = trees.bin_features(torch.from_numpy(X), torch.from_numpy(edges))
    assert got.dtype == torch.uint8  # 32 bins: the forest's uint8 ids
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(trees, "BIN_CHUNK_ELEMS", 2 * X.shape[0])  # two features at a time
    np.testing.assert_array_equal(
        trees.bin_features(torch.from_numpy(X), torch.from_numpy(edges)).numpy(), want
    )


@pytest.mark.parametrize("max_bins,dtype", [(2, torch.uint8), (255, torch.uint8),
                                            (256, torch.uint8), (257, torch.int32),
                                            (300, torch.int32)])
def test_bin_features_uint8_up_to_256_bins_int32_above(max_bins, dtype):
    """uint8 bins at max_bins <= 256 (ids up to 255), int32 above, with the
    JAX package's values either way."""
    rng = np.random.default_rng(max_bins)
    X = rng.normal(size=(20_000, 3)).astype(np.float32)
    edges = jax_trees.quantile_bin_edges(X, max_bins)
    got = trees.bin_features(torch.from_numpy(X), torch.from_numpy(edges))
    want = jax_trees.bin_features(X, edges)
    assert got.dtype == dtype
    assert int(got.max()) == max_bins - 1  # the top bin is used, and fits the type
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


# --------------------------------------------------------- impurity algebra


@pytest.mark.parametrize("impurity", ["gini", "entropy", "variance"])
def test_impurity_algebra_matches(impurity):
    rng = np.random.default_rng(3)
    s = 3
    stats = rng.poisson(3.0, size=(40, 7, s)).astype(np.float32)
    stats[0, :3] = 0.0  # empty nodes
    if impurity == "variance":
        stats[..., 1] = rng.normal(size=(40, 7)).astype(np.float32) * stats[..., 0]
        stats[..., 2] = stats[..., 1] ** 2 + stats[..., 0]
    t = torch.from_numpy(stats)
    j = jnp.asarray(stats)
    np.testing.assert_array_equal(
        trees._stat_weight(t, impurity).numpy(), np.asarray(jax_trees._stat_weight(j, impurity))
    )
    got = trees._impurity_times_w(t, impurity).numpy()
    want = np.asarray(jax_trees._impurity_times_w(j, impurity))
    if impurity == "entropy":  # XLA's CPU log is not torch's in the last bit
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        trees._leaf_value(t, impurity).numpy(), np.asarray(jax_trees._leaf_value(j, impurity))
    )


def test_top_k_max_and_argmax_tie_rules_match():
    rng = np.random.default_rng(4)
    scores = rng.random((16, 64)).astype(np.float32)
    scores[3, 10:20] = 0.5  # ties: the lowest index first
    for k in (1, 8, 64):
        wv, wi = jax_selection.top_k_max(jnp.asarray(scores), k)
        gv, gi = selection.top_k_max(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    gain = np.full((3, 9), -np.inf, np.float32)
    gain[1, [2, 5]] = 0.25  # two equal maxima: the first
    assert np.asarray(jnp.argmax(gain, axis=1)).tolist() == [0, 2, 0]
    assert torch.argmax(torch.from_numpy(gain), dim=1).tolist() == [0, 2, 0]


# ------------------------------------------------------------------- trees


def _build_both(X, stats, depth, nbins, impurity, k, min_instances=1, min_info_gain=0.0):
    edges = jax_trees.quantile_bin_edges(X, nbins)
    Xb = jax_trees.bin_features(X, edges)
    want = jax_trees.build_tree(
        jnp.asarray(Xb), jnp.asarray(stats), jnp.asarray(edges), jax.random.PRNGKey(11),
        max_depth=depth, nbins=nbins, impurity=impurity, k_features=k,
        min_instances=min_instances, min_info_gain=min_info_gain,
    )
    got = trees.build_tree(
        torch.from_numpy(Xb), torch.from_numpy(stats), torch.from_numpy(edges),
        torch.Generator(), max_depth=depth, nbins=nbins, impurity=impurity, k_features=k,
        min_instances=min_instances, min_info_gain=min_info_gain,
    )
    return {k_: v.numpy() for k_, v in got.items()}, {k_: np.asarray(v) for k_, v in want.items()}


@pytest.mark.parametrize("impurity,n_classes", [("gini", 2), ("gini", 3), ("entropy", 2), ("entropy", 3)])
@pytest.mark.parametrize("depth", [0, 1, 5])
def test_build_tree_all_features_matches(impurity, n_classes, depth):
    X, stats = _class_data(n_classes=n_classes, seed=depth)
    got, want = _build_both(X, stats, depth, 16, impurity, X.shape[1])
    _assert_heap(got, want, impurity)


@pytest.mark.parametrize("impurity", ["gini", "entropy"])
def test_build_tree_feature_subset_matches_with_replayed_scores(impurity, monkeypatch):
    X, stats = _class_data(d=9, seed=7)
    depth = 4
    key = jax.random.PRNGKey(11)
    draws = []
    for t in range(depth):
        key, sub = jax.random.split(key)
        draws.append(np.array(jax.random.uniform(sub, (2**t, 9))))
    it = iter(draws)
    monkeypatch.setattr(trees, "_feature_scores", lambda g, w, d, dev: torch.from_numpy(next(it)))
    got, want = _build_both(X, stats, depth, 16, impurity, 3)
    _assert_heap(got, want, impurity)


def test_build_tree_min_instances_and_min_info_gain_match():
    X, stats = _class_data(n=800, seed=9)
    got, want = _build_both(X, stats, 5, 32, "gini", 6, min_instances=40, min_info_gain=0.01)
    _assert_heap(got, want, "gini")
    assert got["is_leaf"][1:8].any()  # the limits made leaves above the last level


def test_build_tree_variance_matches_within_tolerance():
    rng = np.random.default_rng(12)
    n, d = 1200, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(X[:, 0] > 0, 3.0, -1.0) + np.where(X[:, 1] > 0.5, 1.5, 0.0)  # clear splits
    y = (y + 0.01 * rng.normal(size=n)).astype(np.float64)
    w = rng.poisson(1.0, n).astype(np.float64)
    stats = np.stack([w, w * y, w * y * y], axis=1).astype(np.float32)
    got, want = _build_both(X, stats, 3, 16, "variance", d)
    _assert_heap(got, want, "variance")


@pytest.mark.parametrize("depth", [0, 3])
def test_root_stats_are_exact_past_2_24_in_any_row_order(depth):
    # integer stats whose root sums pass 2^24 while every bin sum stays below
    # it: the root's stats are the exact sums rounded once, so every row
    # order grows the same tree (the rule a fit across ranks relies on)
    rng = np.random.default_rng(21)
    n, d, nbins = 512, 4, 16
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.integers(1, 1 << 18, n) | 1  # odd weights: partial sums past 2^24 round
    cls = (X[:, 0] > 0).astype(np.int64)
    stats = np.zeros((n, 2), np.float32)
    stats[np.arange(n), cls] = w
    exact = np.bincount(cls, weights=w, minlength=2)
    edges = torch.from_numpy(trees.quantile_bin_edges(torch.from_numpy(X), nbins))
    bins = trees.bin_features(torch.from_numpy(X), edges).numpy()
    most = max(np.bincount(bins[:, f], weights=w).max() for f in range(d))
    assert exact.min() > 2**24 and most < 2**24
    heaps = []
    for order in (np.arange(n), rng.permutation(n), np.arange(n)[::-1].copy()):
        Xb = trees.bin_features(torch.from_numpy(X[order]), edges)
        heaps.append(trees.build_tree(
            Xb, torch.from_numpy(stats[order]), edges, torch.Generator(), max_depth=depth,
            nbins=nbins, impurity="gini", k_features=d, min_instances=1, min_info_gain=0.0))
    root = np.float32(exact.astype(np.float32).sum(dtype=np.float32))
    assert heaps[0]["node_weight"][1].item() == root
    for h in heaps[1:]:
        for key in HEAP:
            np.testing.assert_array_equal(h[key].numpy(), heaps[0][key].numpy(), err_msg=key)


def test_predict_forest_matches_and_routes_nan_left():
    X, stats = _class_data(n=1000, d=5, seed=13)
    kw = dict(n_trees=4, max_depth=4, max_bins=16, impurity="gini", feature_subset=5,
              min_instances=1, min_info_gain=0.0, subsampling_rate=1.0, bootstrap=True, seed=3)
    forest = jax_trees.forest_fit(X, stats, **kw)
    Xq = X[:300].copy()
    Xq[::7, forest["feature"][0, 1]] = np.nan  # the root's feature of tree 0
    Xq[::5, 4] = np.nan
    want = np.asarray(jax_trees.predict_forest(
        jnp.asarray(Xq), forest["feature"], forest["threshold"], forest["is_leaf"],
        forest["value"], 4))
    got = trees.predict_forest(
        torch.from_numpy(Xq), *(torch.from_numpy(forest[k]) for k in HEAP[:4]), 4
    ).numpy()
    np.testing.assert_array_equal(got, want)
    # a NaN in the root's feature goes left: tree 0's walk passes slot 2
    one = {k: torch.from_numpy(forest[k][:1]) for k in HEAP[:4]}
    row = torch.from_numpy(Xq[:1])
    left = trees.predict_forest(row, one["feature"], one["threshold"], one["is_leaf"], one["value"], 1)
    np.testing.assert_array_equal(left.numpy()[0], forest["value"][0, 2])


@pytest.mark.parametrize(
    "impurity,n_classes,k,bootstrap,rate",
    [("gini", 2, 6, True, 1.0), ("gini", 3, 2, True, 1.0), ("entropy", 2, 2, False, 0.7),
     ("gini", 2, 6, False, 1.0)],
)
def test_forest_fit_matches(impurity, n_classes, k, bootstrap, rate, replay_scores):
    X, stats = _class_data(n=1200, n_classes=n_classes, seed=14)
    kw = dict(n_trees=3, max_depth=4, max_bins=16, impurity=impurity, feature_subset=k,
              min_instances=1, min_info_gain=0.0, subsampling_rate=rate, bootstrap=bootstrap,
              seed=21)
    want = jax_trees.forest_fit(X, stats, **kw)
    replay_scores(21, 3, 4, X.shape[1])
    got = trees.forest_fit(torch.from_numpy(X), torch.from_numpy(stats), **kw)
    _assert_heap(got, want, impurity)
    np.testing.assert_array_equal(got["bin_edges"], want["bin_edges"])


def test_forest_fit_grows_on_uint8_bins(replay_scores, monkeypatch):
    """forest_fit hands the level histogram uint8 bins at maxBins <= 256, and
    its forest is the JAX package's, bit for bit (gini, integer stats)."""
    X, stats = _class_data(n=1200, seed=15)
    kw = dict(n_trees=2, max_depth=4, max_bins=32, impurity="gini", feature_subset=6,
              min_instances=1, min_info_gain=0.0, subsampling_rate=1.0, bootstrap=True, seed=5)
    want = jax_trees.forest_fit(X, stats, **kw)
    seen = set()
    hist = trees.node_bin_histogram

    def spy(Xb, *args):
        seen.add(Xb.dtype)
        return hist(Xb, *args)

    monkeypatch.setattr(trees, "node_bin_histogram", spy)
    replay_scores(5, 2, 4, X.shape[1])
    got = trees.forest_fit(torch.from_numpy(X), torch.from_numpy(stats), **kw)
    assert seen == {torch.uint8}
    _assert_heap(got, want, "gini")


@pytest.mark.parametrize(
    "strategy,d,cls,want",
    [("auto", 64, True, 8), ("auto", 64, False, 21), ("all", 7, True, 7), ("sqrt", 10, False, 3),
     ("log2", 64, True, 6), ("onethird", 9, True, 3), ("4", 9, True, 4), ("0.5", 9, True, 4)],
)
def test_resolve_feature_subset_matches(strategy, d, cls, want):
    assert trees.resolve_feature_subset(strategy, d, cls) == want
    assert jax_trees.resolve_feature_subset(strategy, d, cls) == want


def test_forest_fit_rejects_bad_sizes():
    X = torch.zeros((10, 2))
    stats = torch.ones((10, 2))
    common = dict(max_bins=4, impurity="gini", feature_subset=2, min_instances=1,
                  min_info_gain=0.0, subsampling_rate=1.0, bootstrap=False, seed=0)
    with pytest.raises(ValueError):
        trees.forest_fit(X, stats, n_trees=0, max_depth=2, **common)
    with pytest.raises(ValueError):
        trees.forest_fit(X, stats, n_trees=1, max_depth=-1, **common)
    with pytest.raises(ValueError):
        trees.resolve_feature_subset("most", 4, True)
