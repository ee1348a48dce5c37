"""PyTorch port, the out-of-core pairwise tier (spark_rapids_ml_torch/ops/
pairwise_streaming.py): streamed exact kNN and DBSCAN on the CPU, where each
tile runs the top-k and count kernels' plain versions, against the JAX
package's streaming_exact_knn / streaming_dbscan_fit_predict and against the
port's own in-core routes, on numpy inputs made from a seed; and the models'
routing above stream_threshold_bytes.

Tolerances.
  * kNN: squared distances (the JAX streamed function's distances squared)
    within 1e-5 · (q2 + max x2) of the other answer's: the JAX expansion form
    leaves a self-pair about 3e-5 in d2, which a square root magnifies to
    5e-3, so distances are compared squared. Ids equal wherever the f64
    distances of consecutive neighbors differ by more than 2e-5 · (q2 + max
    x2) (tests/test_torch_knn.py's rule), and equal everywhere against the
    port's in-core search, whose plain scan computes every pair's d2 from the
    same norms; with the stored norms passed, the streamed d2 are the in-core
    ones within the same 1e-5 (the CPU's matmul rounds by block shape; on the
    card the kernel's d2 of a pair does not depend on the tile, chip_smoke.py
    phase 3o).
  * DBSCAN, the borderline rule of tests/test_torch_multiprocess_dbscan.py:
    a pair is borderline when its f64 d2 (of the f32 rows the scan runs on)
    lies within 16 · 2^-23 · (|a|² + |b|²) of eps². Counts may differ by at
    most a row's borderline pairs; labels are equal as numbers at every row
    but a borderline pair's ends and the clusters (in either labeling) of a
    row whose core flag differs, and at most 0.1% of the rows differ."""

import numpy as np
import pandas as pd
import pytest
import torch

import spark_rapids_ml_tpu.config as jax_config
from spark_rapids_ml_tpu.ops import pairwise_streaming as jax_ps
from spark_rapids_ml_torch import config
from spark_rapids_ml_torch.clustering import DBSCAN
from spark_rapids_ml_torch.core import estimator
from spark_rapids_ml_torch.knn import NearestNeighbors
from spark_rapids_ml_torch.models import dbscan as dbscan_model
from spark_rapids_ml_torch.models import from_attributes
from spark_rapids_ml_torch.models import knn as knn_model
from spark_rapids_ml_torch.ops import dbscan, device_cache, ingest, knn
from spark_rapids_ml_torch.ops import pairwise_streaming as ps
from spark_rapids_ml_torch.utils import record_spans

CPU = torch.device("cpu")
BAND_ULPS = 16.0  # chip_smoke.py's DB_BAND_ULPS
MOVED_SHARE = 1e-3


@pytest.fixture(autouse=True)
def restore_config():
    yield
    for key in ("stream_threshold_bytes", "knn_precision", "cache.enabled",
                "cache.hbm_budget_bytes", "device"):
        config.unset(key)
    jax_config.unset("stream_threshold_bytes")


def _blobs(n, d, k=5, seed=0, sep=10.0, noise=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, sep, (k, d))
    return (centers[rng.integers(0, k, n)] + rng.normal(0, noise, (n, d))).astype(np.float32)


def _normal(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _tol(Q, X):
    """1e-5 · (q2 + max x2) per query, in f64."""
    Q, X = Q.astype(np.float64), X.astype(np.float64)
    return 1e-5 * ((Q * Q).sum(1) + (X * X).sum(1).max())


def _sure(Q, X, k):
    """Per (query, rank) whether the rank's neighbor is separated from both
    its neighbors in f64 by more than 2e-5 · (q2 + max x2)."""
    Q64, X64 = Q.astype(np.float64), X.astype(np.float64)
    d2 = np.sort(((Q64[:, None, :] - X64[None, :, :]) ** 2).sum(-1), axis=1)[:, : k + 1]
    gaps = np.diff(d2, axis=1)
    tol = 2 * _tol(Q, X)[:, None]
    inf = np.full((len(Q), 1), np.inf)
    lo = np.concatenate([inf, gaps[:, : k - 1]], axis=1)
    hi = gaps[:, :k] if d2.shape[1] > k else np.concatenate([gaps[:, : k - 1], inf], axis=1)
    return (lo > tol) & (hi > tol)


def _in_core(Q, X, k, x2=None):
    d2, ids = knn.exact_knn_single(
        torch.from_numpy(Q), torch.from_numpy(X), torch.ones(len(X), dtype=torch.bool), k,
        x2=None if x2 is None else torch.from_numpy(x2))
    return d2.numpy(), ids.numpy().astype(np.int64)


# ---------------------------------------------------------------------- kNN


@pytest.mark.parametrize("qblock,iblock", [(256, 512), (1000, 700), (64, 3001), (4096, 131072)])
def test_streamed_knn_matches_the_jax_streamed_function_and_in_core(qblock, iblock):
    X = _normal(3001, 12, seed=1)  # ragged tails at every block pair
    Q = np.concatenate([X[:150], _normal(107, 12, seed=2)])
    d2, ids = ps.streaming_exact_knn(Q, X, 7, CPU, qblock, iblock)
    assert d2.shape == (257, 7) and d2.dtype == np.float32 and ids.dtype == np.int64
    jd, ji = jax_ps.streaming_exact_knn(Q, X, 7, query_block=qblock, item_block=iblock)
    tol = _tol(Q, X)[:, None]
    assert (np.abs(d2.astype(np.float64) - np.asarray(jd, np.float64) ** 2) <= tol).all()
    sure = _sure(Q, X, 7)
    np.testing.assert_array_equal(ids[sure], np.asarray(ji)[sure])
    assert sure.mean() > 0.9
    ref_d2, ref_ids = _in_core(Q, X, 7)
    np.testing.assert_array_equal(ids, ref_ids)
    assert (np.abs(d2 - ref_d2) <= tol).all()
    np.testing.assert_array_equal(ids[:150, 0], np.arange(150))  # self-queries first


def test_streamed_knn_with_k_above_the_tile_rows_keeps_k():
    """k = 50 over 40-row tiles: each tile gives 40 candidates, the running
    merge keeps 50 (the JAX test test_streaming_knn_k_larger_than_item_block)."""
    X = _normal(500, 8, seed=2)
    Q = X[:31]
    x2 = knn.center_norms_sq(torch.from_numpy(X)).numpy()
    d2, ids = ps.streaming_exact_knn(Q, X, 50, CPU, 16, 40, norms=x2)
    ref_d2, ref_ids = _in_core(Q, X, 50, x2)
    np.testing.assert_array_equal(ids, ref_ids)
    assert (np.abs(d2 - ref_d2) <= _tol(Q, X)[:, None]).all()
    jd, ji = jax_ps.streaming_exact_knn(Q, X, 50, query_block=16, item_block=40)
    sure = _sure(Q, X, 50)
    np.testing.assert_array_equal(ids[sure], np.asarray(ji)[sure])
    # k above the items: min(k, n) columns
    d2, ids = ps.streaming_exact_knn(Q, X[:30], 50, CPU, 16, 8)
    assert ids.shape == (31, 30)
    np.testing.assert_array_equal(np.sort(ids, axis=1), np.tile(np.arange(30), (31, 1)))


def test_streamed_knn_computes_each_tile_norm_once_and_replays_the_cache():
    X = _blobs(1000, 6, seed=3)
    Q = _blobs(300, 6, seed=4)
    ps.reset_counters()
    device_cache.reset_counters()
    with record_spans() as spans:
        cached = ps.streaming_exact_knn(Q, X, 5, CPU, 100, 256)
    # 4 tiles uploaded once, replayed by the other 2 query blocks' sweeps
    assert ps.counters["knn.x2_tile_computes"] == 4
    assert device_cache.counters["uploads"] == 4 and device_cache.counters["hits"] == 8
    assert {"pairwise.query_block", "stream.ingest", "select", "merge"} <= set(spans)
    config.set("cache.enabled", False)
    ps.reset_counters()
    plain = ps.streaming_exact_knn(Q, X, 5, CPU, 100, 256)
    assert ps.counters["knn.x2_tile_computes"] == 12
    for a, b in zip(cached, plain):
        np.testing.assert_array_equal(a, b)


def _spy_stage_block(monkeypatch):
    """Record the rows of every block ingest stages."""
    rows, real = [], ingest.stage_block

    def spy(arr, s, e, *args, **kwargs):
        rows.append(e - s)
        return real(arr, s, e, *args, **kwargs)

    monkeypatch.setattr(ingest, "stage_block", spy)
    return rows


def _no_stage(monkeypatch, *modules):
    def refuse(X, *args, **kwargs):
        raise AssertionError(f"staged a block of shape {np.shape(X)} whole")

    for module in modules:
        monkeypatch.setattr(module, "stage", refuse)


def test_knn_model_routes_streamed_and_stages_nothing_whole(monkeypatch):
    X = _blobs(900, 10, seed=7)
    df = pd.DataFrame({"features": list(X), "id": np.arange(900) * 3 + 1})
    qdf = pd.DataFrame({"features": list(X[:40]), "id": np.arange(40) + 10_000})
    est = NearestNeighbors(k=6, inputCol="features", idCol="id", device="cpu")
    ref = est.fit(df).kneighbors(qdf)[2]
    calls, real = [], ps.streaming_exact_knn

    def streamed(Q, items, k, device, **kwargs):  # 250-row tiles: 4 of them
        calls.append(len(items))
        return real(Q, items, k, device, query_block=16, item_block=250, **kwargs)

    monkeypatch.setattr(knn_model, "streaming_exact_knn", streamed)
    monkeypatch.setattr(knn_model, "streaming_norms",
                        lambda items, device: ps.streaming_norms(items, device, 250))
    rows = _spy_stage_block(monkeypatch)
    _no_stage(monkeypatch, knn_model, estimator)
    config.set("stream_threshold_bytes", 1024)
    ps.reset_counters()
    ingest.reset_counters()
    model = est.fit(df)
    assert model._staged is None and ps.counters["knn.x2_tile_computes"] == 4
    np.testing.assert_array_equal(model.get_model_attributes()["item_norms_sq"],
                                  knn.center_norms_sq(torch.from_numpy(X)).numpy())
    _, _, got = model.kneighbors(qdf)
    joined = model.exactNearestNeighborsJoin(qdf, distCol="dist")
    assert calls == [900, 900]
    # the search reads the stored norms: no tile norm is computed again
    assert ps.counters["knn.x2_tile_computes"] == 4
    assert max(rows) <= 250 and ingest.counters["bytes_zero_copy"] > X.nbytes
    np.testing.assert_array_equal(got["query_id"], np.arange(40) + 10_000)
    for a, b in zip(ref["indices"], got["indices"]):
        np.testing.assert_array_equal(a, b)
    for a, b, q in zip(ref["distances"], got["distances"], X[:40]):
        tol = 1e-5 * (float(q @ q) + float((X * X).sum(1).max()))
        assert (np.abs(a.astype(np.float64) ** 2 - b.astype(np.float64) ** 2) <= tol).all()
    assert len(joined) == 240 and set(joined["item_id"]) <= set(df["id"])


def test_knn_streamed_scan_ignores_knn_precision():
    """knn_precision names the in-core scan's form; the stream scans in f32."""
    X = _blobs(700, 9, seed=8)
    config.set("stream_threshold_bytes", 1024)
    model = NearestNeighbors(k=5, inputCol="features", device="cpu").fit(X)
    want = model.kneighbors(X[:50])[2]
    config.set("knn_precision", "bfloat16")
    with record_spans() as spans:
        got = model.kneighbors(X[:50])[2]
    assert spans.attrs["select"]["precision"] == "float32"
    for col in ("indices", "distances"):
        np.testing.assert_array_equal(np.stack(got[col]), np.stack(want[col]))


def test_knn_model_from_attributes_streams_and_honors_item_valid():
    X = _blobs(600, 5, seed=9)
    valid = np.ones(600, bool)
    valid[::7] = False
    model = from_attributes("nearest_neighbors", {
        "item_features": X, "item_ids": np.arange(600) + 50, "item_valid": valid}, device="cpu")
    model.setInputCol("features").setK(4)
    config.set("stream_threshold_bytes", 1024)
    _, _, got = model.kneighbors(X[:30])
    assert model._staged is None
    ids = np.stack(got["indices"])
    live = np.nonzero(valid)[0]
    _, ref = _in_core(X[:30], X[live], 4)
    np.testing.assert_array_equal(ids, live[ref] + 50)


def test_knn_streamed_query_with_a_nan_raises():
    X = _blobs(300, 4, seed=10)
    config.set("stream_threshold_bytes", 1024)
    model = NearestNeighbors(k=3, inputCol="features", device="cpu").fit(X)
    Q = X[:5].copy()
    Q[2, 1] = np.nan
    with pytest.raises(ValueError, match="row 2"):
        model.kneighbors(Q)


# -------------------------------------------------------------------- DBSCAN


def _scan_rows(X, metric):
    """The f32 rows a streamed scan runs on (a numpy-normalized copy under the
    cosine metric) and its eps²."""
    eps, name = metric
    if name == "cosine":
        return X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-30), 2.0 * eps
    return X, eps * eps


def _band_pairs(X, metric):
    rows, eps2 = _scan_rows(X, metric)
    X64 = rows.astype(np.float64)
    sq = (X64 * X64).sum(1)
    d2 = np.maximum(sq[:, None] - 2.0 * X64 @ X64.T + sq[None, :], 0.0)
    return (np.abs(d2 - eps2) <= BAND_ULPS * 2.0**-23 * (sq[:, None] + sq[None, :])).sum(1)


def _assert_same_under_the_rule(got, want, ends, flipped):
    allowed = ends | flipped
    for labels in (got, want):
        keys = np.where(labels >= 0, labels, -1 - np.arange(len(labels)))
        allowed |= np.isin(keys, keys[flipped])
    moved = got != want
    assert not (moved & ~allowed).any()
    assert moved.sum() <= MOVED_SHARE * len(got)


def _cases():
    rng = np.random.default_rng(11)
    blobs = _blobs(1200, 8, k=4, seed=3, sep=12.0, noise=0.4)
    blobs[::101] += 60.0  # isolated rows: noise
    noisy = _blobs(400, 6, k=2, seed=4, sep=20.0, noise=0.3)
    noisy[::97] += 100.0  # isolated rows: noise
    dirs = rng.normal(size=(3, 6))
    cosine = np.concatenate(
        [(dirs[i] + rng.normal(0, 0.05, (300, 6))) * rng.uniform(0.5, 4, (300, 1))
         for i in range(3)] + [rng.normal(size=(100, 6))]).astype(np.float32)
    return {
        "blobs": (blobs, 2.5, 5, "euclidean", 300, 500),
        "noise_and_borders": (noisy, 2.0, 4, "euclidean", 128, 96),
        "cosine": (cosine, 0.02, 6, "cosine", 256, 333),
        "chain": (_chain(120, rng), 1.5, 2, "euclidean", 64, 50),
    }


def _chain(n, rng):
    """n points 1.0 apart on a line (jitter 0.05 in 3 more columns), rows
    shuffled: one cluster whose labels take many rounds to propagate."""
    chain = np.zeros((n, 4), np.float32)
    chain[:, 0] = np.arange(float(n))
    chain[:, 1:] = rng.normal(0, 0.05, (n, 3))
    return chain[rng.permutation(n)]


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_dbscan_matches_the_jax_streamed_function_and_in_core(case, monkeypatch):
    X, eps, min_samples, metric, qblock, iblock = CASES[case]
    counts, real = [], ps._streamed_counts

    def recorded(*args):
        counts.append(real(*args))
        return counts[-1]

    monkeypatch.setattr(ps, "_streamed_counts", recorded)
    rounds = dbscan._propagate_labels.rounds
    got = ps.streaming_dbscan_fit_predict(X, eps, min_samples, CPU, metric, query_block=qblock,
                                          item_block=iblock)
    rounds = dbscan._propagate_labels.rounds - rounds
    jax_labels = np.asarray(jax_ps.streaming_dbscan_fit_predict(
        X, eps, min_samples, metric=metric, query_block=qblock, item_block=iblock))
    ends = _band_pairs(X, (eps, metric))
    rows, eps2 = _scan_rows(X, (eps, metric))
    t = torch.from_numpy(np.ascontiguousarray(rows))
    one = dbscan.fused_count_below(t, t, torch.ones(len(X), dtype=torch.bool), eps2).numpy()
    assert (np.abs(counts[0].astype(np.int64) - one) <= ends).all()
    flipped = (counts[0] >= min_samples) != (one >= min_samples)
    assert not (flipped & (ends == 0)).any()
    assert got.dtype == np.int64 and got.shape == (len(X),)
    _assert_same_under_the_rule(got, jax_labels, ends > 0, flipped)
    in_core = dbscan.dbscan_fit_predict(torch.from_numpy(X), torch.ones(len(X), dtype=torch.bool),
                                        eps, min_samples, metric=metric)
    _assert_same_under_the_rule(got, in_core, ends > 0, flipped)
    assert got.max() >= 0 and (case == "chain" or (got == -1).any())
    if case == "chain":
        assert got.max() == 0 and rounds > 20


def test_streamed_dbscan_cosine_zero_row_raises():
    X = _blobs(100, 4, seed=5)
    X[3] = 0.0
    with pytest.raises(ValueError, match="zero-length"):
        ps.streaming_dbscan_fit_predict(X, 0.2, 5, CPU, "cosine")


@pytest.mark.parametrize("max_rounds", [0, 3, 64])
def test_streamed_dbscan_max_rounds_cuts_the_loop(max_rounds):
    """A 300-point chain needs more than 64 rounds: the loop stops at
    max_rounds and the border pass sweeps once more, in both packages."""
    chain = _chain(300, np.random.default_rng(12))
    ps.reset_counters()
    got = ps.streaming_dbscan_fit_predict(chain, 1.5, 2, CPU, max_rounds=max_rounds,
                                          query_block=64, item_block=100)
    assert ps.counters["dbscan.rounds"] == max_rounds
    assert ps.counters["dbscan.core_blocks"] == 5
    want = jax_ps.streaming_dbscan_fit_predict(chain, 1.5, 2, max_rounds=max_rounds,
                                               query_block=64, item_block=100)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(np.unique(got)) > 1  # unconverged: more than one label on one chain


def test_dbscan_model_routes_streamed_and_stages_nothing_whole(monkeypatch):
    X = _blobs(800, 8, k=3, seed=6, sep=15.0)
    df = pd.DataFrame({"features": list(X)})
    model = DBSCAN(eps=2.5, min_samples=5, device="cpu").fit(df)
    ref = model.transform(df)["prediction"].to_numpy()
    calls, real = [], ps.streaming_dbscan_fit_predict

    def streamed(X, **kwargs):
        calls.append(len(X))
        return real(X, query_block=200, item_block=300, **kwargs)

    monkeypatch.setattr(dbscan_model, "streaming_dbscan_fit_predict", streamed)
    rows = _spy_stage_block(monkeypatch)
    _no_stage(monkeypatch, estimator)
    config.set("stream_threshold_bytes", 1024)
    ps.reset_counters()
    with record_spans() as spans:
        got = model.transform(df)["prediction"].to_numpy()
    assert calls == [800] and max(rows) <= 300
    assert ps.counters["dbscan.core_blocks"] == 4 and ps.counters["dbscan.rounds"] >= 1
    assert {"core_mask", "propagate", "border", "stream.ingest"} <= set(spans)
    ends = _band_pairs(X, (2.5, "euclidean")) > 0
    _assert_same_under_the_rule(got, ref, ends, np.zeros(len(X), bool))
    # a threshold at or above the rows' bytes, or 0: in-core
    for threshold in (X.nbytes, 0):
        config.set("stream_threshold_bytes", threshold)
        monkeypatch.setattr(estimator, "stage", lambda X, device, ring=None: torch.from_numpy(X))
        calls.clear()
        model.transform(df)
        assert calls == []
