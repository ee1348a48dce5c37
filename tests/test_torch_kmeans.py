"""PyTorch port, KMeans end to end on the CPU (spark_rapids_ml_torch.clustering)
against the JAX package's estimator on the same numpy input; and the precision
keys: every estimator of the port fits under fast_math and under
parity_precision="high", and KMeans's bf16-split fits keep the f32 fit.

The k-means|| Gumbel noise comes from different generators in the two
packages, so centers are matched up to a permutation (within 1e-4) and the
inertia within rtol 1e-4; transform labels agree after the same permutation.
The host-side weighted k-means++ is a copy and must agree bit for bit."""

import numpy as np
import pandas as pd
import pytest
import torch

import spark_rapids_ml_tpu.clustering as jax_clustering
from spark_rapids_ml_tpu.ops.kmeans import _weighted_kmeans_pp as jax_weighted_kmeans_pp
from spark_rapids_ml_torch.clustering import KMeans
from spark_rapids_ml_torch.ops import kmeans as torch_kmeans
from spark_rapids_ml_torch.ops import lloyd


def _blobs(n=2000, d=5, k=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 10, (k, d))
    X = centers[rng.integers(0, k, n)] + rng.normal(0, 0.5, (n, d))
    return X.astype(np.float32)


def _perm(got, want):
    """perm[i] = index of want's center nearest got's center i (a bijection)."""
    d = ((got[:, None, :] - want[None, :, :]) ** 2).sum(-1)
    perm = d.argmin(1)
    assert sorted(perm) == list(range(len(want)))
    return perm


@pytest.mark.parametrize("k", [3, 12, 80])
def test_weighted_kmeans_pp_is_the_jax_copy(k):
    rng = np.random.default_rng(k)
    cand = rng.normal(0, 3, (161, 7)).astype(np.float32)
    weights = rng.uniform(1e-12, 50, 161).astype(np.float32)
    got = torch_kmeans._weighted_kmeans_pp(cand, weights, k, np.random.default_rng(9))
    want = jax_weighted_kmeans_pp(cand, weights, k, np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)


def test_kmeans_fit_and_transform_match_the_jax_estimator():
    X = _blobs()
    want = jax_clustering.KMeans(k=4, seed=1).fit(X)
    got = KMeans(k=4, seed=1, device="cpu").fit(X)
    perm = _perm(got.cluster_centers_, want.cluster_centers_)
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_[perm], atol=1e-4)
    assert got.inertia_ == pytest.approx(want.inertia_, rel=1e-4)
    assert got.summary.clusterSizes == [want.summary.clusterSizes[p] for p in perm]
    lab_t = got.transform(X)["prediction"].to_numpy()
    lab_j = want.transform(X)["prediction"].to_numpy()
    np.testing.assert_array_equal(perm[lab_t], lab_j)


def test_weight_col_routes_the_weighted_step(monkeypatch):
    X = _blobs(n=1500, seed=3)
    w = np.random.default_rng(2).uniform(0.5, 3.0, len(X)).astype(np.float32)
    df = pd.DataFrame({"features": list(X), "w": w})
    seen = []
    real = lloyd.lloyd_step
    monkeypatch.setattr(lloyd, "lloyd_step", lambda X, C, n, w=None, n_split=3:
                        seen.append(w is not None) or real(X, C, n, w, n_split))
    got = KMeans(k=4, seed=1, weightCol="w", device="cpu").fit(df)
    assert seen and all(seen)
    want = jax_clustering.KMeans(k=4, seed=1, weightCol="w").fit(df)
    perm = _perm(got.cluster_centers_, want.cluster_centers_)
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_[perm], atol=1e-4)
    assert got.inertia_ == pytest.approx(want.inertia_, rel=1e-4)


def test_unit_weight_routes_the_unit_weight_step(monkeypatch):
    seen = []
    real = lloyd.lloyd_step
    monkeypatch.setattr(lloyd, "lloyd_step", lambda X, C, n, w=None, n_split=3:
                        seen.append(w is None) or real(X, C, n, w, n_split))
    model = KMeans(k=3, seed=2, device="cpu").fit(_blobs(n=500, k=3))
    assert seen and all(seen) and len(seen) == model.summary.numIter


def test_random_init_picks_distinct_real_rows():
    X = torch.from_numpy(_blobs(n=300))
    w = torch.ones(300)
    w[:100] = 0.0
    got = torch_kmeans.kmeans_init(X, w, 5, "random", 2, seed=4)
    rows = {tuple(r) for r in X[100:].numpy()}
    assert got.shape == (5, 5) and all(tuple(r) in rows for r in got)
    assert len({tuple(r) for r in got}) == 5


def test_cosine_raises_not_implemented():
    with pytest.raises(NotImplementedError):
        KMeans(k=2, distanceMeasure="cosine", device="cpu").fit(_blobs(n=100))


def _estimator_fits():
    """name -> (fit and transform at a small size on the CPU, returning arrays;
    whether the fit reads no precision key, so its output is bit-equal under
    either)."""
    import spark_rapids_ml_torch.classification as torch_classification
    import spark_rapids_ml_torch.knn as torch_knn
    import spark_rapids_ml_torch.regression as torch_regression
    from spark_rapids_ml_torch.clustering import DBSCAN
    from spark_rapids_ml_torch.feature import PCA

    X = _blobs(n=600, d=5, k=3, seed=11)
    df = pd.DataFrame({"features": list(X), "label": X @ np.arange(1.0, 6.0) + 1.0,
                       "id": np.arange(600)})
    cf = pd.DataFrame({"features": list(X), "label": (X[:, 0] > X[:, 0].mean()) * 1.0})

    def knn():
        nn = torch_knn.NearestNeighbors(k=4, inputCol="features", idCol="id", device="cpu").fit(df)
        out = nn.kneighbors(df.iloc[:20])[2]
        return np.stack(out["indices"].to_numpy()), np.stack(out["distances"].to_numpy())

    return {
        "PCA": (lambda: (PCA(k=2, inputCol="features", device="cpu").fit(X).explained_variance_,),
                False),
        "KMeans": (lambda: (KMeans(k=3, seed=1, device="cpu").fit(X).cluster_centers_,), False),
        "LinearRegression": (lambda: (torch_regression.LinearRegression(device="cpu").fit(df)
                                      .coefficients,), False),
        "DBSCAN": (lambda: (DBSCAN(eps=3.0, min_samples=5, device="cpu").fit(X).transform(X)
                            ["prediction"].to_numpy(),), True),
        "NearestNeighbors": (knn, True),
        "RandomForestClassifier": (lambda: (np.stack(torch_classification.RandomForestClassifier(
            numTrees=3, maxDepth=3, seed=2, device="cpu").fit(cf).transform(cf)["probability"]
            .to_numpy()),), True),
        "RandomForestRegressor": (lambda: (torch_regression.RandomForestRegressor(
            numTrees=3, maxDepth=3, seed=2, device="cpu").fit(df).transform(df)["prediction"]
            .to_numpy(),), True),
    }


ESTIMATORS = ["PCA", "KMeans", "LinearRegression", "DBSCAN", "NearestNeighbors",
              "RandomForestClassifier", "RandomForestRegressor"]


@pytest.mark.parametrize("key, value", [("fast_math", True), ("parity_precision", "high")])
@pytest.mark.parametrize("name", ESTIMATORS)
def test_every_estimator_fits_under_each_precision_key(name, key, value):
    """fast_math is read by KMeans alone and parity_precision by the KMeans,
    PCA and LinearRegression kernels, as in the JAX package: every estimator
    fits under either, and DBSCAN, kNN and the forests give the same bits as
    under the defaults."""
    from spark_rapids_ml_torch import config

    fit, unaffected = _estimator_fits()[name]
    default = fit()
    config.set(key, value)
    try:
        got = fit()
    finally:
        config.unset(key)
    assert all(np.isfinite(g).all() for g in got)
    if unaffected:
        assert all(np.array_equal(g, d) for g, d in zip(got, default))


@pytest.mark.parametrize("name", ["PCA", "KMeans", "LinearRegression"])
def test_an_unknown_parity_precision_raises_value_error(name):
    from spark_rapids_ml_torch import config

    fit, _ = _estimator_fits()[name]
    config.set("parity_precision", "medium")
    try:
        with pytest.raises(ValueError, match="parity_precision must be 'highest' or 'high'"):
            fit()
    finally:
        config.unset("parity_precision")


@pytest.mark.parametrize("key, value, n_split", [("fast_math", True, 1),
                                                 ("parity_precision", "high", 2)])
@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_split_fit_keeps_the_f32_fit(key, value, n_split, weighted, monkeypatch):
    """Well-separated blobs: under fast_math (the Lloyd step at n_split 1, the
    assignment at parity) and under "high" (both at n_split 2) the fit has the
    f32 fit's n_iter and cluster sizes, and centers within 2^-8 (n_split 1:
    means of bf16-rounded values) or 2^-14 (n_split 2) of max |center|."""
    from spark_rapids_ml_torch import config
    from spark_rapids_ml_torch.ops import select

    X = _blobs(n=3000, d=6, k=5, seed=17)
    data = X
    kwargs = {}
    if weighted:
        w = np.random.default_rng(3).uniform(0.5, 2.0, len(X)).astype(np.float32)
        data = pd.DataFrame({"features": list(X), "w": w})
        kwargs = {"weightCol": "w"}
    want = KMeans(k=5, seed=1, device="cpu", **kwargs).fit(data)
    steps, assigns = [], []
    real_step, real_assign = lloyd.lloyd_step, select.assign
    monkeypatch.setattr(lloyd, "lloyd_step", lambda X, C, n, w=None, n_split=3:
                        steps.append(n_split) or real_step(X, C, n, w, n_split))
    monkeypatch.setattr(torch_kmeans, "assign", lambda X, C, n_split=3:
                        assigns.append(n_split) or real_assign(X, C, n_split))
    config.set(key, value)
    try:
        got = KMeans(k=5, seed=1, device="cpu", **kwargs).fit(data)
    finally:
        config.unset(key)
    assert set(steps) == {n_split} and len(steps) == got.summary.numIter
    assert set(assigns) == {2 if n_split == 2 else 3}
    assert got.summary.numIter == want.summary.numIter
    perm = _perm(got.cluster_centers_, want.cluster_centers_)
    assert got.summary.clusterSizes == [want.summary.clusterSizes[p] for p in perm]
    tol = {1: 2.0**-8, 2: 2.0**-14}[n_split] * np.abs(want.cluster_centers_).max()
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_[perm], atol=tol)
    assert got.inertia_ == pytest.approx(want.inertia_, rel=1e-4)


def test_unsupported_param_raises_at_fit():
    with pytest.raises(ValueError):
        KMeans(k=2, solver="block", device="cpu").fit(_blobs(n=100))


def test_float64_kmeans_raises_not_implemented():
    X = _blobs(n=100).astype(np.float64)
    with pytest.raises(NotImplementedError):
        KMeans(k=2, float32_inputs=False, device="cpu").fit(X)
    model = KMeans(k=2, device="cpu").fit(X)  # by default f64 input is cast to f32
    assert model.transform(X)["prediction"].nunique() == 2
    model._set_params(float32_inputs=False)
    with pytest.raises(NotImplementedError):
        model.transform(X)


def test_record_spans_times_each_stage_of_fit_and_transform():
    from spark_rapids_ml_torch import utils

    X = _blobs(n=500)
    with utils.record_spans() as fit_t:
        model = KMeans(k=4, device="cpu").fit(X)
    assert set(fit_t) == {
        "extract", "stage", "init.oversample", "init.weighting", "init.kmeans_pp",
        "lloyd_loop", "inertia", "summary",
    }
    with utils.record_spans() as transform_t:
        model.transform(X)
    assert set(transform_t) == {"extract", "stage", "compute", "output"}
    assert all(t >= 0.0 for t in [*fit_t.values(), *transform_t.values()])
    assert utils._spans is None  # nothing records outside the block
    with utils.record_spans() as random_t:
        KMeans(k=4, initMode="random", device="cpu").fit(X)
    assert "init.random" in random_t and "init.oversample" not in random_t


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_a_non_finite_feature_raises_at_fit(bad):
    """k-means|| would draw from NaN probabilities; the fit names the row."""
    X = _blobs(n=200, seed=5)
    X[42, 3] = bad
    with pytest.raises(ValueError, match="row 42 has a NaN or infinite"):
        KMeans(k=3, seed=1, device="cpu").fit(X)


def test_a_nan_row_goes_to_center_0_in_assign_and_lloyd():
    """The assign and Lloyd kernels' rule (csrc/nearest.cuh), kept by their
    plain versions: a NaN row's distances are all NaN, and it lands in center 0."""
    from spark_rapids_ml_torch.ops import select

    X = torch.from_numpy(_blobs(n=300, seed=6))
    X[5, 0] = float("nan")
    C = X[[10, 20, 30]].clone()
    labels = select.assign(X, C)
    assert int(labels[5]) == 0
    _, counts, _ = lloyd.lloyd_step(X, C, 300)
    _, counts_without, _ = lloyd.lloyd_step(X[torch.arange(300) != 5], C, 299)
    assert float(counts[0]) == float(counts_without[0]) + 1.0
