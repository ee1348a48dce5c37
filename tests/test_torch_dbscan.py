"""PyTorch port, DBSCAN (spark_rapids_ml_torch.clustering.DBSCAN and
ops/dbscan.py) against the JAX package's (spark_rapids_ml_tpu.clustering.DBSCAN,
ops/dbscan.py) on the same numpy inputs. The port's CPU wrapper runs the count
kernel's plain version; the JAX side runs its XLA core-mask scan, whose counts
its own tests hold bit-identical to its Pallas count kernel.

Tolerance: labels, core masks and neighbor minima are exact. Each eps is placed
in a gap between pair distances, and the tests check that no pair's d2 lies
within 1e-6·(|a| + |b|)² of eps², so f32 rounding in either package cannot
move a pair across it."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu.clustering import DBSCAN as JaxDBSCAN
from spark_rapids_ml_tpu.ops import dbscan as jax_dbscan
from spark_rapids_ml_torch.clustering import DBSCAN, DBSCANModel
from spark_rapids_ml_torch.ops import count, dbscan


def _blobs(seed=0, d=5, n_blob=80, n_noise=12, spread=4.0):
    rng = np.random.default_rng(seed)
    parts = [rng.normal(c, 0.4, (n_blob, d)) for c in (-spread, spread, 0.0)]
    parts.append(rng.uniform(-10, 10, (n_noise, d)))
    X = np.concatenate(parts).astype(np.float32)
    return X[rng.permutation(len(X))]


def _clear_eps2(X, target):
    """A squared radius near target² in the widest gap between neighboring pair
    distances, and the check that every pair's d2 lies at least
    1e-6·(|a| + |b|)² from it: some 17 f32 ulps of the terms d2 is computed
    from, so neither package's rounding moves a pair across it."""
    X = X.astype(np.float64)
    sq = (X * X).sum(1)
    d2 = np.maximum(sq[:, None] - 2 * X @ X.T + sq[None, :], 0)
    v = np.unique(d2.ravel())
    i = np.searchsorted(v, target * target)
    lo = max(i - 2000, 0)
    j = lo + int(np.argmax(np.diff(v[lo : i + 2000])))
    eps2 = 0.5 * (v[j] + v[j + 1])
    norms = np.sqrt(sq)
    assert np.all(np.abs(d2 - eps2) >= 1e-6 * (norms[:, None] + norms[None, :]) ** 2)
    return eps2


@pytest.mark.parametrize("seed, eps, min_samples", [(0, 1.2, 5), (1, 0.9, 8), (2, 1.5, 3)])
def test_euclidean_labels_equal_the_jax_estimator(seed, eps, min_samples):
    X = _blobs(seed)
    eps = float(np.sqrt(_clear_eps2(X, eps)))
    df = pd.DataFrame({"features": list(X)})
    want = JaxDBSCAN(eps=eps, min_samples=min_samples).fit(df).transform(df)["prediction"].to_numpy()
    before = count.fused_count_below.launches
    got = DBSCAN(eps=eps, min_samples=min_samples, device="cpu").fit(df).transform(df)
    assert count.fused_count_below.launches == before  # the CPU ran the plain version
    got = got["prediction"].to_numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert (got == -1).any() and got.max() >= 2  # noise, and the three blobs


def test_cosine_labels_equal_the_jax_estimator():
    rng = np.random.default_rng(3)
    dirs = rng.normal(size=(3, 6))
    X = np.concatenate([
        (dirs[i] + rng.normal(0, 0.05, (60, 6))) * rng.uniform(0.5, 4, (60, 1)) for i in range(3)
    ] + [rng.normal(size=(10, 6))]).astype(np.float32)
    Xn = X / np.linalg.norm(X, axis=1, keepdims=True)
    eps = 0.5 * _clear_eps2(Xn, np.sqrt(2 * 0.02))  # cosine distance <= eps: d2 <= 2·eps
    want = JaxDBSCAN(eps=eps, min_samples=4, metric="cosine").fit(X).transform(X)["prediction"].to_numpy()
    got = DBSCAN(eps=eps, min_samples=4, metric="cosine", device="cpu").fit(X).transform(X)
    np.testing.assert_array_equal(got["prediction"].to_numpy(), want)


def test_cosine_rejects_an_all_zero_row():
    X = _blobs(4)
    X[7] = 0.0
    with pytest.raises(ValueError, match="zero-length"):
        DBSCAN(eps=0.1, metric="cosine", device="cpu").fit(X).transform(X)


def test_ops_with_invalid_rows_equal_the_jax_package():
    X = _blobs(5)
    valid = np.random.default_rng(5).random(len(X)) > 0.2
    eps2 = _clear_eps2(X, 1.1)
    eps = float(np.sqrt(eps2))
    Xj, vj = jnp.asarray(X), jnp.asarray(valid)
    Xt, vt = torch.from_numpy(X), torch.from_numpy(valid)
    core_j = np.asarray(jax_dbscan._core_mask(Xj, vj, eps2, 5))
    core_t = dbscan._core_mask(Xt, vt, eps2, 5)
    np.testing.assert_array_equal(core_t.numpy(), core_j)
    labels = np.random.default_rng(6).permutation(len(X)).astype(np.int32)
    mins_j = np.asarray(jax_dbscan._min_core_neighbor_labels(Xj, jnp.asarray(labels), jnp.asarray(core_j), eps2))
    mins_t = dbscan._min_core_neighbor_labels(Xt, torch.from_numpy(labels), core_t, eps2, block=50)
    np.testing.assert_array_equal(mins_t.numpy(), mins_j)
    want = jax_dbscan.dbscan_fit_predict(Xj, vj, eps, 5)
    got = dbscan.dbscan_fit_predict(Xt, vt, eps, 5)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[~valid] == -1)


def test_hook_and_jump_matches_the_jax_package():
    rng = np.random.default_rng(7)
    n = 64
    labels = np.minimum(np.arange(n), rng.integers(0, n, n)).astype(np.int32)
    labels = labels[labels]  # labels index rows
    mins = rng.integers(0, n, n).astype(np.int32)
    core = rng.random(n) > 0.3
    want = np.asarray(jax_dbscan._hook_and_jump(jnp.asarray(labels), jnp.asarray(mins), jnp.asarray(core)))
    got = dbscan._hook_and_jump(torch.from_numpy(labels), torch.from_numpy(mins), torch.from_numpy(core))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_rounds", [1, 2, 64])
def test_propagation_rounds_and_the_unconverged_border_pass(max_rounds):
    X = _blobs(8, n_blob=150)
    valid = np.ones(len(X), bool)
    eps = float(np.sqrt(_clear_eps2(X, 1.2)))
    want = jax_dbscan.dbscan_fit_predict(jnp.asarray(X), jnp.asarray(valid), eps, 5, max_rounds=max_rounds)
    before = dbscan._propagate_labels.rounds
    got = dbscan.dbscan_fit_predict(torch.from_numpy(X), torch.from_numpy(valid), eps, 5, max_rounds=max_rounds)
    np.testing.assert_array_equal(got, want)
    rounds = dbscan._propagate_labels.rounds - before
    assert 1 <= rounds <= max_rounds


def test_compact_labels_match_the_jax_package():
    out = np.array([7, -1, 3, 7, 12, 3, -1, 5], np.int64)
    np.testing.assert_array_equal(dbscan._compact_labels(out), jax_dbscan._compact_labels(out))
    np.testing.assert_array_equal(dbscan._compact_labels(out), [0, -1, 1, 0, 2, 1, -1, 3])


def test_fit_does_no_compute_and_carries_the_params():
    before = count.fused_count_below.launches, dbscan._propagate_labels.rounds
    est = DBSCAN(eps=0.7, min_samples=3, idCol="id", device="cpu")
    model = est.fit(pd.DataFrame({"features": [np.zeros(2, np.float32)] * 3}))
    assert isinstance(model, DBSCANModel)
    assert (count.fused_count_below.launches, dbscan._propagate_labels.rounds) == before
    assert model.getOrDefault("eps") == 0.7 and model.getOrDefault("min_samples") == 3
    assert model.getIdCol() == "id"
    assert est._torch_params == JaxDBSCAN(eps=0.7, min_samples=3)._tpu_params


@pytest.mark.parametrize(
    "params, exc",
    [
        ({"eps": 0.0}, ValueError),
        ({"min_samples": 0}, ValueError),
        ({"metric": "manhattan"}, ValueError),
        ({"float32_inputs": False}, NotImplementedError),
    ],
)
def test_unsupported_params_raise_at_fit(params, exc):
    with pytest.raises(exc):
        DBSCAN(device="cpu", **params).fit(_blobs(9))


def test_a_nan_row_is_noise_in_both_packages():
    """A row with a NaN feature counts no neighbor (a NaN distance is never
    within eps, and the count kernel's clamp keeps the NaN), so it is no core
    point and joins no cluster: -1, as in the JAX package. 60 x 3, two blobs."""
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(-3, 0.3, (30, 3)), rng.normal(3, 0.3, (30, 3))])
    X = X.astype(np.float32)
    X[17, 1] = np.nan
    df = pd.DataFrame({"features": list(X)})
    want = JaxDBSCAN(eps=1.0, min_samples=5).fit(df).transform(df)["prediction"].to_numpy()
    got = DBSCAN(eps=1.0, min_samples=5, device="cpu").fit(df).transform(df)["prediction"]
    got = got.to_numpy()
    np.testing.assert_array_equal(got, want)
    assert got[17] == -1 and len(set(got) - {-1}) == 2
    t = torch.from_numpy(X)
    counts = count.fused_count_below(t, t, torch.ones(60, dtype=torch.bool), 1.0)
    assert counts[17] == 0 and int(counts.min(0).values) == 0 and int(counts[16]) >= 5
