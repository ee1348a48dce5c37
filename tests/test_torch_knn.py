"""PyTorch port, exact k-NN estimator (spark_rapids_ml_torch/knn.py) with
device="cpu" against the JAX package's NearestNeighbors on the same numpy
inputs, mirroring tests/test_knn.py's cases.

Tolerance. Neighbor ids are equal wherever the f64 distances of consecutive
neighbors differ by more than 2e-5 * (q2 + max x2) (the kernel-level tolerance
of tests/test_torch_topk.py); distances agree within rtol 1e-4, atol 5e-3 after
the square root: the JAX package's own floor for two exact paths
(tests/test_pairwise_streaming.py::test_knn_model_routes_streamed), set by the
expansion's cancellation near zero distance (a self-distance is 0 on one path
and ~4e-3 on another)."""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import spark_rapids_ml_tpu.config as jax_config
import spark_rapids_ml_tpu.knn as jax_knn
from spark_rapids_ml_tpu.ops import knn as jax_ops_knn
from spark_rapids_ml_torch import config
from spark_rapids_ml_torch.core.estimator import stage
from spark_rapids_ml_torch.knn import NearestNeighbors, NearestNeighborsModel
from spark_rapids_ml_torch.models import from_attributes
from spark_rapids_ml_torch.ops import knn as ops_knn
from spark_rapids_ml_torch.ops import selection, topk
from spark_rapids_ml_torch.utils import record_spans


def _data(n_items=500, n_queries=40, d=16, seed=0):
    rng = np.random.default_rng(seed)
    items = rng.normal(size=(n_items, d)).astype(np.float32)
    queries = rng.normal(size=(n_queries, d)).astype(np.float32)
    return items, queries


def _frame(X, **cols):
    return pd.DataFrame({"features": list(X), **cols})


def _arrays(knn_df):
    return np.stack(knn_df["indices"].to_numpy()), np.stack(knn_df["distances"].to_numpy())


def _assert_same_neighbors(got, want, items, queries):
    """`got` and `want` are (ids, distances); ids may differ only at near-ties."""
    g_ids, g_d = got
    w_ids, w_d = want
    assert g_ids.shape == w_ids.shape and g_ids.dtype == np.int64
    np.testing.assert_allclose(g_d, w_d, rtol=1e-4, atol=5e-3)
    Q, X = queries.astype(np.float64), items.astype(np.float64)
    d2 = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    ref = np.sort(d2, axis=1)[:, : g_ids.shape[1] + 1]
    tol = 2e-5 * ((Q * Q).sum(1) + (X * X).sum(1).max())
    gaps = np.diff(ref, axis=1)
    k = g_ids.shape[1]
    lo = np.concatenate([np.full((len(Q), 1), np.inf), gaps[:, : k - 1]], axis=1)
    hi = gaps[:, :k] if ref.shape[1] > k else np.concatenate(
        [gaps[:, : k - 1], np.full((len(Q), 1), np.inf)], axis=1)
    sure = (lo > tol[:, None]) & (hi > tol[:, None])
    np.testing.assert_array_equal(g_ids[sure], w_ids[sure])
    assert sure.mean() > 0.9


def test_exact_knn_matches_the_jax_package():
    items, queries = _data()
    jax_est = jax_knn.NearestNeighbors(k=7, inputCol="features")
    est = NearestNeighbors(k=7, inputCol="features", device="cpu")
    w = jax_est.fit(_frame(items)).kneighbors(_frame(queries))[2]
    g = est.fit(_frame(items)).kneighbors(_frame(queries))[2]
    assert list(g.columns) == [c.replace(jax_est.uid, est.uid) for c in w.columns]
    _assert_same_neighbors(_arrays(g), _arrays(w), items, queries)


def test_exact_knn_with_id_col():
    items, queries = _data(n_items=100, n_queries=5, d=4, seed=1)
    item_ids = np.arange(100, dtype=np.int64) * 10 + 3  # non-contiguous ids
    query_ids = np.arange(5, dtype=np.int64) + 1000
    item_df = _frame(items, my_id=item_ids)
    query_df = _frame(queries, my_id=query_ids)
    want = jax_knn.NearestNeighbors(k=3, inputCol="features", idCol="my_id").fit(item_df)
    got = NearestNeighbors(k=3, inputCol="features", idCol="my_id", device="cpu").fit(item_df)
    w_items, w_queries, w = want.kneighbors(query_df)
    g_items, g_queries, g = got.kneighbors(query_df)
    assert g_items is item_df and list(g_queries.columns) == list(w_queries.columns)
    np.testing.assert_array_equal(g["query_my_id"].to_numpy(), query_ids)
    ids, dists = _arrays(g)
    assert set(ids.ravel()) <= set(item_ids)
    pos = (ids - 3) // 10
    _assert_same_neighbors((pos, dists), ((_arrays(w)[0] - 3) // 10, _arrays(w)[1]), items, queries)


def test_numpy_input_numbers_the_rows_and_names_the_id_column_by_uid():
    items, queries = _data(n_items=60, n_queries=6, d=3, seed=2)
    est = NearestNeighbors(k=2, inputCol="features", device="cpu")
    model = est.fit(items)
    _, q_out, knn_df = model.kneighbors(queries)
    assert q_out is queries
    assert list(knn_df.columns) == [f"query_unique_id_{est.uid}", "indices", "distances"]
    np.testing.assert_array_equal(knn_df[f"query_unique_id_{est.uid}"].to_numpy(), np.arange(6))
    want = jax_knn.NearestNeighbors(k=2, inputCol="features").fit(items).kneighbors(queries)[2]
    _assert_same_neighbors(_arrays(knn_df), _arrays(want), items, queries)


def test_exact_knn_join_matches_the_jax_package():
    items, queries = _data(n_items=50, n_queries=4, d=3, seed=2)
    jax_est = jax_knn.NearestNeighbors(k=2, inputCol="features")
    est = NearestNeighbors(k=2, inputCol="features", device="cpu")
    w = jax_est.fit(_frame(items)).exactNearestNeighborsJoin(_frame(queries), distCol="dist")
    g = est.fit(_frame(items)).exactNearestNeighborsJoin(_frame(queries), distCol="dist")
    assert len(g) == 4 * 2
    assert list(g.columns) == [c.replace(jax_est.uid, est.uid) for c in w.columns]
    assert list(g.dtypes) == list(w.dtypes)
    np.testing.assert_array_equal(g.iloc[:, :2].to_numpy(), w.iloc[:, :2].to_numpy())
    np.testing.assert_allclose(g["dist"], w["dist"], rtol=1e-4, atol=5e-3)


def test_knn_not_persistable():
    with pytest.raises(NotImplementedError):
        NearestNeighbors(k=2, inputCol="features", device="cpu").write()


@pytest.mark.parametrize("k", [5, 10, 1000])
def test_knn_k_larger_than_items_clamps(k):
    items, queries = _data(n_items=5, n_queries=3, d=4, seed=3)
    want = jax_knn.NearestNeighbors(k=k, inputCol="features").fit(_frame(items))
    got = NearestNeighbors(k=k, inputCol="features", device="cpu").fit(_frame(items))
    w = _arrays(want.kneighbors(_frame(queries))[2])
    g = _arrays(got.kneighbors(_frame(queries))[2])
    assert g[0].shape == (3, 5)  # clamped to the item count
    _assert_same_neighbors(g, w, items, queries)


def test_self_query_finds_itself_first_at_near_zero_distance():
    items, _ = _data(n_items=300, n_queries=1, d=8, seed=4)
    model = NearestNeighbors(k=4, inputCol="features", device="cpu").fit(items)
    ids, dists = _arrays(model.kneighbors(items)[2])
    np.testing.assert_array_equal(ids[:, 0], np.arange(300))
    assert float(dists[:, 0].max()) <= 5e-3


def test_jax_fitted_model_carries_across_both_ways():
    items, queries = _data(n_items=200, n_queries=12, d=6, seed=5)
    ids = np.arange(200, dtype=np.int64)[::-1].copy()
    jax_model = jax_knn.NearestNeighbors(k=4, inputCol="features", idCol="id").fit(_frame(items, id=ids))
    want = jax_model.kneighbors(_frame(queries))[2]
    port = from_attributes("nearest_neighbors", jax_model.get_model_attributes(), device="cpu")
    assert isinstance(port, NearestNeighborsModel)
    port.setInputCol("features").setK(4).setIdCol("id")
    got = port.kneighbors(_frame(queries))[2]
    _assert_same_neighbors(_arrays(got), _arrays(want), items, queries)
    back = jax_knn.NearestNeighborsModel(**port.get_model_attributes())
    back.setInputCol("features").setK(4).setIdCol("id")
    np.testing.assert_array_equal(_arrays(back.kneighbors(_frame(queries))[2])[0], _arrays(want)[0])


def test_carried_valid_mask_gives_the_short_tail():
    """A JAX model with deleted items (the incremental tier's valid mask):
    slots past the live items name id -1 in both packages, and the join
    drops them."""
    items, queries = _data(n_items=6, n_queries=3, d=3, seed=6)
    jax_model = jax_knn.NearestNeighbors(k=5, inputCol="features").fit(_frame(items))
    jax_model.delete_items(np.array([0, 2, 5]))
    want = _arrays(jax_model.kneighbors(_frame(queries))[2])
    port = from_attributes("nearest_neighbors", jax_model.get_model_attributes(), device="cpu")
    port.setInputCol("features").setK(5)
    got = _arrays(port.kneighbors(_frame(queries))[2])
    np.testing.assert_array_equal(got[0], want[0])
    assert np.all(got[0][:, 3:] == -1) and set(got[0][:, :3].ravel()) <= {1, 3, 4}
    np.testing.assert_allclose(got[1][:, :3], want[1][:, :3], rtol=1e-4, atol=5e-3)
    joined = port.exactNearestNeighborsJoin(_frame(queries))
    assert len(joined) == 3 * 3 and (joined.iloc[:, 1] >= 0).all()


@pytest.mark.parametrize("id_col", [None, "id"])
@pytest.mark.parametrize("k", [10, 200, 256])
def test_benchmark_traffic_matches_the_jax_package(k, id_col):
    """The repo's exact-kNN benchmark's traffic (benchmark/benchmark/
    bench_nearest_neighbors.py: k = 200, the first 100 rows of the items as
    queries) at a small size, around k = 200 up to the kernel's K_MAX."""
    items, _ = _data(n_items=2000, n_queries=1, d=32, seed=12)
    queries = items[:100]
    cols = {} if id_col is None else {id_col: np.arange(2000, dtype=np.int64) + 7}
    kw = {} if id_col is None else {"idCol": id_col}
    w = jax_knn.NearestNeighbors(k=k, inputCol="features", **kw).fit(_frame(items, **cols))
    g = NearestNeighbors(k=k, inputCol="features", device="cpu", **kw).fit(_frame(items, **cols))
    qcols = {} if id_col is None else {id_col: np.arange(100, dtype=np.int64)}
    want = _arrays(w.kneighbors(_frame(queries, **qcols))[2])
    got = _arrays(g.kneighbors(_frame(queries, **qcols))[2])
    off = 0 if id_col is None else 7
    np.testing.assert_array_equal(got[0][:, 0], np.arange(100) + off)  # each row finds itself
    _assert_same_neighbors((got[0] - off, got[1]), (want[0] - off, want[1]), items, queries)


@pytest.mark.parametrize("layout", ["read_only", "strided"])
def test_stage_on_the_cpu_never_aliases_a_read_only_or_strided_array(layout):
    base = np.arange(24, dtype=np.float32).reshape(4, 6)
    X = base[:, ::2] if layout == "strided" else base.copy()
    X.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no "not writable" warning either
        t = stage(X, torch.device("cpu"))
    assert t.is_contiguous() and not np.shares_memory(t.numpy(), X)
    np.testing.assert_array_equal(t.numpy(), X)


def test_float64_features_raise_not_implemented():
    items, _ = _data(n_items=20, n_queries=1, d=3, seed=11)
    with pytest.raises(NotImplementedError, match="f32"):
        NearestNeighbors(k=2, inputCol="features", float32_inputs=False, device="cpu").fit(items)


def test_k_above_the_kernels_limit_raises():
    items, queries = _data(n_items=400, n_queries=2, d=3, seed=9)
    model = NearestNeighbors(k=topk.K_MAX + 1, inputCol="features", device="cpu").fit(items)
    with pytest.raises(ValueError, match="K_MAX"):
        model.kneighbors(queries)


def test_record_spans_times_the_stages_of_fit_and_kneighbors():
    items, queries = _data(n_items=80, n_queries=4, d=3, seed=10)
    with record_spans() as fit_spans:
        model = NearestNeighbors(k=3, inputCol="features", device="cpu").fit(items)
    with record_spans() as search_spans:
        model.kneighbors(queries)
    assert set(fit_spans) == {"extract", "stage", "norms"}
    assert set(search_spans) == {"extract", "stage", "select", "output"}
    np.testing.assert_array_equal(
        model.get_model_attributes()["item_norms_sq"], (items * items).sum(1, dtype=np.float32)
    )
    assert isinstance(model._staged[1], torch.Tensor)


# ---------------------------------------------------------------- the narrow forms
# knn_precision = "bfloat16" or "int8": the top-k scan ranks an oversampled
# pool in that form and an exact f32 re-rank cuts it to k, as the JAX package
# does under knn.selection = pallas_fused and the same knn.pallas_precision
# (its Pallas kernel in interpret mode here). Tolerance: both packages' returned
# d2 are the difference form's f32 sums of the same candidates, taken in
# another order, within RERANK_RTOL = d * 2^-23 of each other (d = 32 here);
# their ids are equal at every rank whose f64 distance lies more than
# 2e-5 * (q2 + max x2) from its neighbors' (as in _assert_same_neighbors):
# the pools are the same candidates wherever their form's ranking separates
# them.
NARROW = ("bfloat16", "int8")


@pytest.fixture
def knn_precision():
    """Set the form in both packages for one test, and unset it after."""

    def set_both(precision):
        config.set("knn_precision", precision)
        jax_config.set("knn.pallas_precision", precision)
        jax_config.set("knn.selection", "pallas_fused")

    yield set_both
    config.unset("knn_precision")
    jax_config.unset("knn.pallas_precision")
    jax_config.unset("knn.selection")


def _search_data(n, d, nq, seed, mask_frac):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[n // 2] = X[n // 10]  # exact ties
    Q = np.concatenate([X[: nq - 4], rng.normal(size=(4, d)).astype(np.float32)])
    valid = rng.random(n) > mask_frac
    return Q, X, valid


@pytest.mark.parametrize("precision", NARROW)
@pytest.mark.parametrize("n, d, nq, k, mask_frac, seed",
                         [(997, 32, 33, 10, 0.2, 0), (600, 32, 20, 3, 0.0, 7), (800, 32, 17, 25, 0.5, 13)])
def test_exact_knn_single_narrow_forms_match_the_jax_package(
    precision, n, d, nq, k, mask_frac, seed, knn_precision
):
    Q, X, valid = _search_data(n, d, nq, seed, mask_frac)
    knn_precision(precision)
    want = [np.asarray(a) for a in jax_ops_knn.exact_knn_single(Q, X, valid, k)]
    t = torch.from_numpy
    got = [a.numpy() for a in ops_knn.exact_knn_single(t(Q), t(X), t(valid), k)]
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    rtol = d * 2.0**-23
    inval = ~valid[got[1]]
    np.testing.assert_array_equal(got[0][inval], np.float32(selection.INVALID_D2))
    np.testing.assert_allclose(got[0][~inval], want[0][~inval], rtol=rtol, atol=0)
    Q64, X64 = Q.astype(np.float64), X.astype(np.float64)
    d64 = ((Q64[:, None, :] - X64[None, :, :]) ** 2).sum(-1)
    d64 = np.where(valid[None, :], d64, float(selection.INVALID_D2))
    tol = 2e-5 * ((Q64 ** 2).sum(1) + (X64[valid] ** 2).sum(1).max())
    ref = np.take_along_axis(d64, want[1].astype(np.int64), 1)
    gap_lo = np.diff(ref, axis=1, prepend=-np.inf)
    gap_hi = np.diff(ref, axis=1, append=np.inf)
    sure = (gap_lo > tol[:, None]) & (gap_hi > tol[:, None])
    np.testing.assert_array_equal(got[1][sure], want[1][sure])
    assert sure.mean() > 0.8


@pytest.mark.parametrize("precision", NARROW)
@pytest.mark.parametrize("k", [1, 10, 33])
def test_returned_neighbors_are_the_rerank_of_their_ids_bit_for_bit(precision, k):
    """The re-rank invariant: the returned (d2, ids) are parity_rerank_sq of
    the returned ids, bit for bit; invalid slots at the sentinel exactly; and
    the re-ranked d2 are the difference form's f32 values."""
    Q, X, valid = (torch.from_numpy(a) for a in _search_data(700, 19, 25, k, 0.3))
    d2, ids = ops_knn.exact_knn_single(Q, X, valid, k, precision=precision)
    d2b, idsb = ops_knn.parity_rerank_sq(Q, X, valid, ids, k)
    assert torch.equal(d2.view(torch.int32), d2b.view(torch.int32)) and torch.equal(ids, idsb)
    diff = torch.sum((X[ids.long()] - Q[:, None, :]) ** 2, dim=-1)
    ok = valid[ids.long()]
    assert torch.equal(d2[ok], diff[ok])
    assert bool((d2[~ok] == selection.INVALID_D2).all())


@pytest.mark.parametrize("block", [1, 4, None])
def test_parity_rerank_sq_blocks_change_nothing(block):
    Q, X, valid = (torch.from_numpy(a) for a in _search_data(300, 7, 12, 5, 0.2))
    cand = torch.from_numpy(np.stack([np.random.default_rng(i).permutation(300)[:30]
                                      for i in range(12)]).astype(np.int32))
    whole = ops_knn.parity_rerank_sq(Q, X, valid, cand, 8, block=1000)
    got = ops_knn.parity_rerank_sq(Q, X, valid, cand, 8, block=block)
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


def test_knn_precision_resolves_caller_then_set_then_env_then_default(monkeypatch):
    monkeypatch.delenv("SRML_TORCH_KNN_PRECISION", raising=False)
    config.unset("knn_precision")
    assert selection.resolve_fused_precision() == "float32"
    monkeypatch.setenv("SRML_TORCH_KNN_PRECISION", "int8")
    assert selection.resolve_fused_precision() == "int8"
    config.set("knn_precision", "bfloat16")
    try:
        assert selection.resolve_fused_precision() == "bfloat16"
        assert selection.resolve_fused_precision("float32") == "float32"
        config.set("knn_precision", "fp8")
        with pytest.raises(ValueError, match="knn_precision"):
            selection.resolve_fused_precision()
    finally:
        config.unset("knn_precision")
    with pytest.raises(ValueError, match="knn_precision"):
        selection.resolve_fused_precision("float16")
    assert selection.FUSED_PRECISIONS == ("float32", "bfloat16", "int8")


@pytest.mark.parametrize("precision", NARROW)
def test_k_whose_pool_exceeds_the_kernels_limit_raises_in_a_narrow_form(precision):
    """A narrow form's pool is k + max(8, k // 4): 256 = K_MAX at k = 205."""
    items, queries = _data(n_items=400, n_queries=2, d=3, seed=9)
    t = torch.from_numpy
    valid = torch.ones(400, dtype=torch.bool)
    d2, _ = ops_knn.exact_knn_single(t(queries), t(items), valid, 205, precision=precision)
    assert d2.shape == (2, 205)
    with pytest.raises(ValueError, match="K_MAX"):
        ops_knn.exact_knn_single(t(queries), t(items), valid, 206, precision=precision)
    model = NearestNeighbors(k=206, inputCol="features", device="cpu").fit(items)
    config.set("knn_precision", precision)
    try:
        with pytest.raises(ValueError, match="K_MAX"):
            model.kneighbors(queries)
    finally:
        config.unset("knn_precision")
    assert model.kneighbors(queries)[2]["indices"].iloc[0].shape == (206,)  # float32: fits


@pytest.mark.parametrize("precision", NARROW)
def test_kneighbors_and_join_in_a_narrow_form(precision, knn_precision):
    """The estimator in a narrow form: the JAX package's neighbors under the
    same form (the rule above), its spans name the form, and the items'
    narrow operand is made once and reused."""
    items, queries = _data(n_items=600, n_queries=30, d=32, seed=3)
    knn_precision(precision)
    want = jax_knn.NearestNeighbors(k=9, inputCol="features").fit(_frame(items)).kneighbors(
        _frame(queries))[2]
    model = NearestNeighbors(k=9, inputCol="features", device="cpu").fit(items)
    with record_spans() as spans:
        got = model.kneighbors(_frame(queries))[2]
    assert spans.attrs["select"] == {"precision": precision, "k": 17}
    assert spans.attrs["rerank"] == {"precision": precision, "k": 9}
    assert {"narrow_items", "select", "rerank"} <= set(spans)
    _assert_same_neighbors(_arrays(got), _arrays(want), items, queries)
    with record_spans() as again:
        joined = model.exactNearestNeighborsJoin(_frame(queries), distCol="dist")
    assert "narrow_items" not in again  # the operand is kept with the staged items
    ids, dist = _arrays(got)
    np.testing.assert_array_equal(joined.iloc[:, 1].to_numpy(), ids.reshape(-1))
    np.testing.assert_array_equal(joined["dist"].to_numpy(), dist.reshape(-1))


# ---------------------------------------------------------------- non-finite features


@pytest.mark.parametrize("precision", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_a_non_finite_query_raises_before_any_kernel(precision, bad):
    items, queries = _data(n_items=50, n_queries=6, d=4, seed=4)
    queries[3, 1] = bad
    model = NearestNeighbors(k=3, inputCol="features", device="cpu").fit(items)
    config.set("knn_precision", precision)
    try:
        for call in (model.kneighbors, model.exactNearestNeighborsJoin):
            with pytest.raises(ValueError, match="row 3 has a NaN or infinite"):
                call(_frame(queries))
    finally:
        config.unset("knn_precision")


def test_a_nan_item_is_never_returned_while_finite_items_fill_k():
    """A NaN item's distances are NaN: the plain selection ranks them above
    every number (and the kernel takes the item as invalid, as its norm is
    NaN), so with k below the finite items it never comes back."""
    items, queries = _data(n_items=60, n_queries=5, d=4, seed=5)
    items[[7, 30]] = np.nan
    model = NearestNeighbors(k=20, inputCol="features", device="cpu").fit(items)
    ids, dist = _arrays(model.kneighbors(queries)[2])
    assert not np.isin(ids, [7, 30]).any() and np.isfinite(dist).all()
