"""PyTorch port, KMeans end to end on the CPU (spark_rapids_ml_torch.clustering)
against the JAX package's estimator on the same numpy input.

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
    monkeypatch.setattr(lloyd, "lloyd_step", lambda X, C, n, w=None: seen.append(w is not None) or real(X, C, n, w))
    got = KMeans(k=4, seed=1, weightCol="w", device="cpu").fit(df)
    assert seen and all(seen)
    want = jax_clustering.KMeans(k=4, seed=1, weightCol="w").fit(df)
    perm = _perm(got.cluster_centers_, want.cluster_centers_)
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_[perm], atol=1e-4)
    assert got.inertia_ == pytest.approx(want.inertia_, rel=1e-4)


def test_unit_weight_routes_the_unit_weight_step(monkeypatch):
    seen = []
    real = lloyd.lloyd_step
    monkeypatch.setattr(lloyd, "lloyd_step", lambda X, C, n, w=None: seen.append(w is None) or real(X, C, n, w))
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


def test_fast_math_raises_not_implemented():
    from spark_rapids_ml_torch import config

    config.set("fast_math", True)
    try:
        with pytest.raises(NotImplementedError):
            KMeans(k=2, device="cpu").fit(_blobs(n=100))
    finally:
        config.unset("fast_math")


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
