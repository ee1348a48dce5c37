"""PyTorch port, exact kNN and the random forests across the ranks of one gloo
process group on the CPU (ops/knn.py exact_knn_distributed / exact_knn_ring,
models/knn.py, ops/trees.py, models/tree.py), each rank passing its own rows
(tests/_torch_mp_worker.py, job "knn_forest").

Jobs: 2 ranks with a 60/40 ragged split, and 3 ranks whose middle rank holds
no rows, run once per session and shared by the xdist workers through a file
lock. Data (numpy, seed 0): 3,001 x 16 normal items and 257 normal queries;
the same items with their last 40 rows copies of their first 40 (copies on
different ranks) and queries that are those rows; 7 items (k = 10 above the
global item count); all 257 queries on rank 0. Forests: 4,001 x 8 normal rows,
a 2-class and a 3-class label, a real-valued label and a weight from
U(0.5, 2); 3 trees of depth 4, 16 bins. Every forest but one replays the JAX
package's jax.random feature scores through ops/trees.py::_feature_scores, as
tests/test_torch_trees.py does, in the ranks and in this process alike.

Tolerances:
  * kNN in f32, both routes: the single-process port search of all the items
    and queries, bit for bit (ids, distances, query ids), the duplicates'
    ties to the lower global position; against the JAX package's
    exact_knn_distributed and exact_knn_ring on a `world`-device CPU mesh,
    tests/test_torch_knn.py's rule (ids equal where the f64 neighbors are
    more than 2e-5 (q2 + max x2) apart, distances within rtol 1e-4, atol
    5e-3). The JAX ring orders a tie by hop: asserted as a stated departure;
  * kNN in bf16 and int8 on the all-gather route: the returned distances
    are parity_rerank_sq of the returned ids bit for bit; each query's sorted
    distances at most the single-process narrow search's, element by
    element; recall@10 against f32 at least chip_smoke.py's gates (0.99
    bf16, 0.8 int8). The ring scans in f32 in every form: its answer is its
    f32 answer, bit for bit;
  * forests: every rank the same bits; against the single-process port fit
    of all the rows, classifiers under unit weights bit for bit, regressors
    and weighted fits under the rule of tests/test_torch_random_forest.py
    (structure equal where a node's best gain is more than 1e-5 above its
    second best and 0, values and predictions within 1e-5 below such
    nodes); against the JAX package's forest_fit with shard_fn and mesh on a
    `world`-device CPU mesh, the same, but entropy gains within rtol 1e-6
    (XLA's CPU log, tests/test_torch_trees.py), and under real-valued stats
    a node's value within 1e-5 + eps32 x (root weight / node weight): both
    packages carry a child's stats as parent - left in f32, so a node's stats
    hold an absolute error of about eps32 x the root's weight, which the
    600-row data of tests/test_torch_random_forest.py keeps under 1e-5 and
    4,001 weighted rows do not (a pure leaf of weight 6.8 under a root of
    about 5,000: class-0 probability +2.0e-5 in the port, -1.6e-5 in the JAX
    package);
  * the collectives of every call are the path's (`search_ops`, `forest_ops`)."""

import fcntl
import functools
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_mp_worker as worker
from spark_rapids_ml_torch import config
from spark_rapids_ml_torch.knn import NearestNeighbors
from spark_rapids_ml_torch.ops import knn as knn_ops
from spark_rapids_ml_torch.ops import trees

REPO = Path(__file__).resolve().parents[1]
N_ITEMS, D_ITEMS, N_QUERIES, N_TINY, N_DUPS = 3001, 16, 257, 7, 40
N_RF, D_RF = 4001, 8
WORLDS = (2, 3)
CHILD_TIMEOUT = 600
HEAP = ("feature", "threshold", "is_leaf", "value", "gain", "node_weight")
SEARCHES = worker.knn_searches()
FOREST = worker.forest_cases()
RECALL_GATE = {"bfloat16": 0.99, "int8": 0.8}
GAIN_TOL = VALUE_RTOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


def _cuts(n, world, all_on_rank_0=False):
    """60/40 on 2 ranks; on 3 the middle rank holds no rows."""
    cut = n if all_on_rank_0 else int(0.6 * n)
    return [0, cut, n] if world == 2 else [0, cut, cut, n]


def _jax_scores(seed, n_trees, depth, d):
    """The JAX package's per-level feature scores (tests/test_torch_trees.py),
    stacked: tree by tree, level by level."""
    import jax

    out = []
    for i in range(n_trees):
        key = jax.random.PRNGKey((seed + 7919 * i) & 0x7FFFFFFF)
        for t in range(depth):
            key, sub = jax.random.split(key)
            out.append(np.array(jax.random.uniform(sub, (2**t, d))))
    return np.concatenate(out)


def _data_sets():
    rng = np.random.default_rng(0)
    items = rng.normal(size=(N_ITEMS, D_ITEMS)).astype(np.float32)
    queries = rng.normal(size=(N_QUERIES, D_ITEMS)).astype(np.float32)
    dups = items.copy()
    dups[-N_DUPS:] = dups[:N_DUPS]
    sets = {
        "items": items, "queries": queries, "dups": dups,
        "dup_queries": dups[np.arange(N_QUERIES) % N_DUPS],
        "tiny": rng.normal(size=(N_TINY, D_ITEMS)).astype(np.float32),
        "rank0_queries": queries,
    }
    out = {}
    for name, X in sets.items():
        out[f"{name}_X"] = X
        out[f"{name}_ids"] = 1000 + 3 * np.arange(len(X), dtype=np.int64)
    X = rng.normal(size=(N_RF, D_RF)).astype(np.float32)
    score = X[:, 0] + 0.5 * X[:, 1] - 0.25 * X[:, 2] + rng.normal(0, 0.5, N_RF)
    y2 = (score > 0).astype(np.float32)
    y3 = np.digitize(score, np.quantile(score, [1 / 3, 2 / 3])).astype(np.float32)
    cut = _cuts(N_RF, 2)[1]
    y3_late = y3.copy()
    y3_late[:cut][y3_late[:cut] == 2] = 1  # class 2 only past the first rank's rows
    y_negative = y2.copy()
    y_negative[-1] = -1.0  # on the last rank
    out.update(
        rf_X=X, rf_y2=y2, rf_y3=y3, rf_y3_late=y3_late, rf_y_negative=y_negative,
        rf_y_gap=2 * y2,  # classes 0 and 2: class 1 on no rank
        rf_yreg=(2.0 * X[:, 0] - X[:, 1] + 0.3 * rng.normal(size=N_RF)).astype(np.float32),
        rf_w=rng.uniform(0.5, 2.0, N_RF).astype(np.float32),
        rf_scores=_jax_scores(worker.RF_SEED, worker.RF_TREES, worker.RF_DEPTH, D_RF),
    )
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_job(world, workdir, sets):
    """One spawned job of `world` ranks, each taking its rows of every set."""
    workdir.mkdir(parents=True, exist_ok=True)
    cuts = {f"{key[:-2]}_cuts": np.array(_cuts(len(X), world, key == "rank0_queries_X"))
            for key, X in sets.items() if key.endswith("_X")}
    np.savez(workdir / "data.npz", **sets, **cuts)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_mp_worker.py"), str(r), str(world),
         str(port), str(workdir), "knn_forest"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"


def _knn_input(sets, name, kind):
    return worker.knn_input(sets[f"{name}_X"], 0, len(sets[f"{name}_X"]), kind, sets[f"{name}_ids"])


def _one_process_searches(sets):
    """(search, form) -> (query ids, ids, distances) of the single-process
    port search of every item and query."""
    out = {}
    for search, (items, queries, k, _, forms, kind) in SEARCHES.items():
        est = NearestNeighbors(k=k, inputCol="features", **({"idCol": "id"} if kind == "ids" else {}))
        model = est.fit(_knn_input(sets, items, kind))
        for form in forms:
            config.set("knn_precision", form)
            try:
                knn_df = model.kneighbors(_knn_input(sets, queries, kind))[2]
            finally:
                config.unset("knn_precision")
            out[(search, form)] = (knn_df.iloc[:, 0].to_numpy(),
                                   np.array(knn_df["indices"].tolist(), np.int64),
                                   np.array(knn_df["distances"].tolist(), np.float32))
    return out


def _one_process_forests(sets):
    """case -> (attributes, the per-level gains in fit order, predictions) of
    the single-process port fit of every row."""
    import pandas as pd

    X = sets["rf_X"]
    out = {}
    real_scores, real_gains = trees._feature_scores, trees._split_gains
    try:
        for case, (kind, label, params, replayed) in FOREST.items():
            trees._feature_scores = real_scores
            if replayed:
                worker.replay(trees, worker.jax_score_list(
                    sets["rf_scores"], worker.RF_TREES, worker.RF_DEPTH, D_RF))
            gains = []

            def recorded(*args, **kwargs):
                gains.append(real_gains(*args, **kwargs))
                return gains[-1]

            trees._split_gains = recorded
            frame = pd.DataFrame({"features": list(X), "label": sets[f"rf_{label}"],
                                  "w": sets["rf_w"]})
            model = worker.forest_estimator(kind, params).fit(frame)
            out[case] = (model.get_model_attributes(), gains,
                         model.transform(frame)["prediction"].to_numpy())
    finally:
        trees._feature_scores, trees._split_gains = real_scores, real_gains
    return out


def _compute(root):
    sets = _data_sets()
    procs = {world: _run_job(world, root / f"world{world}", sets) for world in WORLDS}
    config.set("device", "cpu")
    try:
        one = {"knn": _one_process_searches(sets), "forest": _one_process_forests(sets)}
    finally:
        config.unset("device")
    for world in WORLDS:
        _wait(procs[world])
    jobs = {}
    for world in WORLDS:
        jobs[world] = []
        for r in range(world):
            with open(root / f"world{world}" / f"rank{r}.pkl", "rb") as f:
                jobs[world].append(pickle.load(f))
    return {"sets": sets, "jobs": jobs, "one": one}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both jobs and the single-process results, computed once for all xdist
    workers (the first worker to take the lock computes; the others read its
    file)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers' common parent
        root = root.parent
    root = root / "torch_multiprocess_knn_forest"
    root.mkdir(parents=True, exist_ok=True)
    done = root / "results.pkl"
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                with open(done.with_suffix(".tmp"), "wb") as f:
                    pickle.dump(_compute(root), f)
                os.replace(done.with_suffix(".tmp"), done)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with open(done, "rb") as f:
        return pickle.load(f)


def _bits_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bits_equal(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _gathered(results, world, search, route, form):
    """(query ids, ids, distances) of every rank's queries, in rank order."""
    ranks = [r["knn"][(search, route, form)] for r in results["jobs"][world]]
    ranks = [r for r in ranks if len(r["query_ids"])]  # a rank with no queries
    return tuple(np.concatenate([r[key] for r in ranks])
                 for key in ("query_ids", "ids", "distances"))


KNN_CALLS = [(world, search, route, form) for world in WORLDS
             for search, (_, _, _, routes, forms, _) in SEARCHES.items()
             for route in routes for form in forms]
KNN_F32 = [(w, s, r) for w, s, r, f in KNN_CALLS if f == "float32"]


def test_the_ranks_joined_one_group(results):
    for world in WORLDS:
        ranks = results["jobs"][world]
        assert [r["process_index"] for r in ranks] == list(range(world))
        assert all(r["process_count"] == world for r in ranks)


@pytest.mark.parametrize("world,search,route", KNN_F32)
def test_knn_f32_is_the_one_process_search_bit_for_bit(results, world, search, route):
    got = _gathered(results, world, search, route, "float32")
    want = results["one"]["knn"][(search, "float32")]
    for g, w, what in zip(got, want, ("query ids", "ids", "distances")):
        assert _bits_equal(g, w), what


@pytest.mark.parametrize("world,form", [(w, f) for w in WORLDS for f in ("bfloat16", "int8")])
def test_knn_narrow_forms_on_the_allgather_route(results, world, form):
    sets = results["sets"]
    X, Q = torch.from_numpy(sets["items_X"]), torch.from_numpy(sets["queries_X"])
    _, ids, dist = _gathered(results, world, "default", "allgather", form)
    _, ids1, dist1 = results["one"]["knn"][("default", form)]
    _, ids32, _ = results["one"]["knn"][("default", "float32")]
    # default ids are the global positions: the re-rank invariant of the ids
    d2, ids_r = knn_ops.parity_rerank_sq(Q, X, torch.ones(N_ITEMS, dtype=torch.bool),
                                         torch.from_numpy(ids).to(torch.int32), worker.KNN_K)
    np.testing.assert_array_equal(ids_r.numpy(), ids)
    assert _bits_equal(np.sqrt(d2.numpy()), dist)
    assert np.all(dist <= dist1), "a distance above the single-process narrow search's"
    recall = np.mean([len(np.intersect1d(a, b)) / worker.KNN_K for a, b in zip(ids, ids32)])
    assert recall >= RECALL_GATE[form], recall


@pytest.mark.parametrize("world,search,form", [(w, s, f) for w in WORLDS
                                               for s, f in (("default", "bfloat16"),
                                                            ("default", "int8"),
                                                            ("k_above_items", "int8"))])
def test_the_ring_scans_in_f32_in_every_form(results, world, search, form):
    got = _gathered(results, world, search, "ring", form)
    want = _gathered(results, world, search, "ring", "float32")
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


def _jax_mesh(world):
    import jax
    from jax.sharding import Mesh

    from spark_rapids_ml_tpu.parallel.mesh import DATA_AXIS, FEATURE_AXIS

    return Mesh(np.array(jax.devices()[:world]).reshape(world, 1), (DATA_AXIS, FEATURE_AXIS))


@functools.lru_cache(maxsize=None)
def _jax_knn(world, items, queries, route):
    """(global positions, distances) of the JAX package's multi-device exact
    kNN on a `world`-device CPU mesh (padding rows trail the real ones, so
    positions are global row numbers)."""
    from spark_rapids_ml_tpu.ops.knn import exact_knn_distributed, exact_knn_ring
    from spark_rapids_ml_tpu.parallel.partition import pad_rows
    from spark_rapids_ml_tpu.parallel.partitioner import partitioner_for

    sets = _data_sets()
    X, Q = sets[f"{items}_X"], sets[f"{queries}_X"]
    mesh = _jax_mesh(world)
    part = partitioner_for(mesh)
    Xp, valid, _ = pad_rows(X, world)
    Xd, vd = part.shard(Xp), part.shard(valid > 0)
    if route == "allgather":
        dist, gidx = exact_knn_distributed(mesh, Q, Xd, vd, worker.KNN_K)
    else:
        Qp, _, _ = pad_rows(Q, world)
        dist, gidx = exact_knn_ring(mesh, part.shard(Qp), Xd, vd, worker.KNN_K)
        dist, gidx = dist[: len(Q)], gidx[: len(Q)]
    return np.asarray(gidx, np.int64), np.asarray(dist, np.float32)


def _assert_same_neighbors(got, want, items, queries):
    """tests/test_torch_knn.py's rule: ids may differ only at near-ties."""
    g_ids, g_d = got
    w_ids, w_d = want
    np.testing.assert_allclose(g_d, w_d, rtol=1e-4, atol=5e-3)
    Q, X = queries.astype(np.float64), items.astype(np.float64)
    d2 = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    k = g_ids.shape[1]
    ref = np.sort(d2, axis=1)[:, : k + 1]
    tol = 2e-5 * ((Q * Q).sum(1) + (X * X).sum(1).max())
    gaps = np.diff(ref, axis=1)
    lo = np.concatenate([np.full((len(Q), 1), np.inf), gaps[:, : k - 1]], axis=1)
    hi = gaps[:, :k]
    sure = (lo > tol[:, None]) & (hi > tol[:, None])
    np.testing.assert_array_equal(g_ids[sure], w_ids[sure])
    assert sure.mean() > 0.9


@pytest.mark.parametrize("world,route", [(w, r) for w in WORLDS for r in worker.KNN_ROUTES])
def test_knn_matches_the_jax_multi_device_search(results, world, route):
    _, ids, dist = _gathered(results, world, "default", route, "float32")
    sets = results["sets"]
    _assert_same_neighbors((ids, dist), _jax_knn(world, "items", "queries", route),
                           sets["items_X"], sets["queries_X"])


@pytest.mark.parametrize("world,route", [(w, r) for w in WORLDS for r in worker.KNN_ROUTES])
def test_duplicate_items_on_two_ranks_go_to_the_lower_global_position(results, world, route):
    _, ids, dist = _gathered(results, world, "duplicates", route, "float32")
    j = np.arange(N_QUERIES) % N_DUPS  # query i is item j, copied to N_ITEMS - N_DUPS + j
    np.testing.assert_array_equal(ids[:, 0], j)
    np.testing.assert_array_equal(ids[:, 1], N_ITEMS - N_DUPS + j)
    assert _bits_equal(dist[:, 0], dist[:, 1])


@pytest.mark.parametrize("world", WORLDS)
def test_the_jax_ring_breaks_duplicate_ties_by_hop_a_stated_departure(results, world):
    """The JAX ring merges [best, hop] by pool position, so a query whose
    device holds the later copy takes that copy first; the port's ring, its
    all-gather route and the JAX all-gather merge take the lower position."""
    j = np.arange(N_QUERIES) % N_DUPS
    ring_ids, ring_d = _jax_knn(world, "dups", "dup_queries", "ring")
    ag_ids, _ = _jax_knn(world, "dups", "dup_queries", "allgather")
    np.testing.assert_array_equal(ag_ids[:, 0], j)
    later = ring_ids[:, 0] != j
    assert later.any()
    np.testing.assert_array_equal(ring_ids[later, 0], N_ITEMS - N_DUPS + j[later])
    np.testing.assert_array_equal(ring_ids[later, 1], j[later])
    np.testing.assert_array_equal(ring_d[:, 0], ring_d[:, 1])
    port = _gathered(results, world, "duplicates", "ring", "float32")[1]
    np.testing.assert_array_equal(port[:, 0], j)


@pytest.mark.parametrize("world", WORLDS)
def test_default_ids_are_global_row_numbers(results, world):
    for r, res in enumerate(results["jobs"][world]):
        lo, hi = _cuts(N_ITEMS, world)[r : r + 2]
        np.testing.assert_array_equal(res["knn"][("default", "fit")]["item_ids"], np.arange(lo, hi))
        np.testing.assert_array_equal(res["knn"][("array", "fit")]["item_ids"], np.arange(lo, hi))
        np.testing.assert_array_equal(res["knn"][("user_ids", "fit")]["item_ids"],
                                      1000 + 3 * np.arange(lo, hi))
        qlo, qhi = _cuts(N_QUERIES, world)[r : r + 2]
        for search in ("default", "array"):
            got = res["knn"][(search, "allgather", "float32")]
            np.testing.assert_array_equal(got["query_ids"], np.arange(qlo, qhi))
        np.testing.assert_array_equal(
            res["knn"][("default", "ring", "float32")]["query_frame_ids"], np.arange(qlo, qhi))


@pytest.mark.parametrize("world,route", [(w, r) for w in WORLDS for r in worker.KNN_ROUTES])
def test_a_rank_without_queries_gets_an_empty_frame(results, world, route):
    ranks = results["jobs"][world]
    empty = [("queries_on_rank_0", r) for r in range(1, world)]
    if world == 3:
        empty.append(("default", 1))
    for search, r in empty:
        got = ranks[r]["knn"][(search, route, "float32")]
        assert got["ids"].shape[0] == 0 and got["distances"].shape[0] == 0
        assert len(got["query_ids"]) == 0 and got["join"].shape[0] == 0
        assert got["columns"][0].startswith("query_unique_id_")
        assert got["columns"][1:] == ["indices", "distances"]


@pytest.mark.parametrize("world,route", [(w, r) for w in WORLDS for r in worker.KNN_ROUTES])
def test_k_above_the_global_item_count_is_clamped(results, world, route):
    _, ids, dist = _gathered(results, world, "k_above_items", route, "float32")
    assert ids.shape == (N_QUERIES, N_TINY) and dist.shape == (N_QUERIES, N_TINY)
    assert np.all(np.sort(ids, axis=1) == np.arange(N_TINY))


@pytest.mark.parametrize("world", WORLDS)
def test_a_nan_query_on_one_rank_raises_on_every_rank(results, world):
    """The last rank holds the NaN: every rank raises after one all-gather
    of (query count, non-finite flag, no room for the ring), before any
    search."""
    for r in results["jobs"][world]:
        assert r["errors"]["nan_query"]["raised"] == "ValueError"
        assert r["errors"]["nan_query"]["comm"]["comm.collective_ops"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_a_model_built_from_attributes_refuses_a_search_under_the_group(results, world):
    for r in results["jobs"][world]:
        assert r["errors"]["from_attributes"] == {
            "raised": "NotImplementedError",
            "comm": {"comm.collective_ops": 0, "comm.collective_bytes": 0}}


def search_ops(world, route):
    """The collectives of a search: one all-gather of (query count,
    non-finite flag, no room for the ring); then the all-gather route's
    gathers of the queries and of the candidates, or the ring's P - 1
    shifts."""
    return 1 + (2 if route == "allgather" else world - 1)


@pytest.mark.parametrize("world,search,route,form", KNN_CALLS)
def test_the_knn_collectives_are_the_routes(results, world, search, route, form):
    comm = [r["knn"][(search, route, form)]["comm"] for r in results["jobs"][world]]
    assert all(c == comm[0] for c in comm)
    assert comm[0]["comm.collective_ops"] == search_ops(world, route)
    fits = [r["knn"][(search, "fit")]["comm"] for r in results["jobs"][world]]
    assert all(f["comm.collective_ops"] == 1 for f in fits)  # the layout's all-gather


@pytest.mark.parametrize("world,search,route,form", KNN_CALLS)
def test_the_join_rows_are_the_kneighbors_rows(results, world, search, route, form):
    for r in results["jobs"][world]:
        got = r["knn"][(search, route, form)]
        k = got["ids"].shape[1] if got["ids"].ndim == 2 and len(got["ids"]) else 0
        join = got["join"]
        assert join.shape == (got["ids"].size, 3)
        if len(join):
            np.testing.assert_array_equal(join[:, 0], np.repeat(got["query_ids"], k))
            np.testing.assert_array_equal(join[:, 1], got["ids"].reshape(-1))
            np.testing.assert_array_equal(join[:, 2].astype(np.float32), got["distances"].reshape(-1))


# ------------------------------------------------------------------- forests

FOREST_CALLS = [(world, case) for world in WORLDS for case in FOREST]


def _exact(case):
    """Integer stats: a classifier under unit weights."""
    kind, _, params, _ = FOREST[case]
    return kind == "classifier" and "weightCol" not in params


def _separated_slots(gains, n_trees, depth):
    """{(tree, heap slot)} of the nodes whose best gain is more than GAIN_TOL
    above both their second best and 0 (tests/test_torch_random_forest.py)."""
    it = iter(gains)
    out = set()
    for i in range(n_trees):
        for t in range(depth):
            top = torch.topk(next(it).reshape(2**t, -1), 2, dim=1).values
            for w in range(2**t):
                best, second = float(top[w, 0]), float(top[w, 1])
                if best - second > GAIN_TOL and best > GAIN_TOL:
                    out.add((i, 2**t + w))
    return out


def _parity_rule(a, b, gains, X, carried=False):
    """tests/test_torch_random_forest.py's rule for real-valued stats. With
    `carried`, a value's tolerance adds the f32 floor of the carried stats
    (module header): eps32 x the root's weight / the node's."""
    n_trees, depth, n = worker.RF_TREES, worker.RF_DEPTH, len(X)
    sep = _separated_slots(gains, n_trees, depth)
    compared = 0
    for i in range(n_trees):
        todo = [1]
        while todo:
            s = todo.pop()
            w = a["node_weight"][i]
            floor = EPS32 * w[1] / w[s] if carried and w[s] > 0 else 0.0
            np.testing.assert_allclose(a["value"][i][s], b["value"][i][s], rtol=VALUE_RTOL,
                                       atol=VALUE_RTOL + floor)
            if (i, s) not in sep or a["is_leaf"][i][s]:
                continue  # a leaf, or a near tie: its subtree may differ
            compared += 1
            assert not b["is_leaf"][i][s]
            assert a["feature"][i][s] == b["feature"][i][s], (i, s)
            assert a["threshold"][i][s] == b["threshold"][i][s], (i, s)
            todo += [2 * s, 2 * s + 1]
    assert compared >= 2 * n_trees
    sure = np.ones(n, bool)
    for i in range(n_trees):
        p = np.ones(n, np.int64)
        for _ in range(depth):
            leaf = a["is_leaf"][i][p]
            sure &= leaf | np.array([(i, s) in sep for s in p])
            go = X[np.arange(n), np.maximum(a["feature"][i][p], 0)] > a["threshold"][i][p]
            p = np.where(leaf, p, 2 * p + go)
    assert sure.mean() > 0.25
    return sure


@pytest.mark.parametrize("world,case", FOREST_CALLS)
def test_every_rank_grows_the_same_forest(results, world, case):
    ranks = results["jobs"][world]
    for r in ranks[1:]:
        assert _bits_equal(r["forest"][case]["attrs"], ranks[0]["forest"][case]["attrs"])


@pytest.mark.parametrize("world,case", FOREST_CALLS)
def test_the_forest_matches_the_one_process_fit(results, world, case):
    got = results["jobs"][world][0]["forest"][case]["attrs"]
    want, gains, pred = results["one"]["forest"][case]
    assert _bits_equal(got["bin_edges"], want["bin_edges"])
    assert got["num_classes"] == want["num_classes"]
    if _exact(case):
        assert _bits_equal({k: got[k] for k in HEAP}, {k: want[k] for k in HEAP})
        return
    sure = _parity_rule(got, want, gains, results["sets"]["rf_X"])
    preds = np.concatenate([r["forest"][case]["prediction"] for r in results["jobs"][world]
                            if r["forest"][case]["prediction"] is not None])
    np.testing.assert_allclose(preds[sure], pred[sure], rtol=VALUE_RTOL, atol=VALUE_RTOL)


@functools.lru_cache(maxsize=None)
def _jax_forest(world, case):
    """The JAX package's forest_fit of every row with shard_fn and mesh on a
    `world`-device CPU mesh."""
    from spark_rapids_ml_tpu.ops import trees as jax_trees
    from spark_rapids_ml_tpu.parallel.partition import pad_rows
    from spark_rapids_ml_tpu.parallel.partitioner import partitioner_for

    sets = _data_sets()
    kind, label, params, _ = FOREST[case]
    X, y = sets["rf_X"], sets[f"rf_{label}"].astype(np.float64)
    w = sets["rf_w"].astype(np.float64) if "weightCol" in params else np.ones_like(y)
    if kind == "classifier":
        stats = np.zeros((len(y), int(y.max()) + 1), np.float32)
        stats[np.arange(len(y)), y.astype(int)] = w
        impurity = params.get("impurity", "gini")
    else:
        stats = np.stack([w, w * y, w * y * y], axis=1).astype(np.float32)
        impurity = "variance"
    mesh = _jax_mesh(world)
    part = partitioner_for(mesh)
    return jax_trees.forest_fit(
        X, stats, n_trees=worker.RF_TREES, max_depth=worker.RF_DEPTH, max_bins=worker.RF_BINS,
        impurity=impurity,
        feature_subset=jax_trees.resolve_feature_subset("auto", D_RF, kind == "classifier"),
        min_instances=1, min_info_gain=0.0, subsampling_rate=params.get("subsamplingRate", 1.0),
        bootstrap=params.get("bootstrap", True), seed=worker.RF_SEED,
        shard_fn=lambda arr: part.shard(pad_rows(arr, world)[0]), mesh=mesh)


@pytest.mark.parametrize("world,case", [(w, c) for w, c in FOREST_CALLS if FOREST[c][3]])
def test_the_forest_matches_the_jax_mesh_fit(results, world, case):
    got = results["jobs"][world][-1]["forest"][case]["attrs"]
    want = {k: np.asarray(v) for k, v in _jax_forest(world, case).items()}
    assert _bits_equal(got["bin_edges"], want["bin_edges"])
    if not _exact(case):
        _parity_rule(got, want, results["one"]["forest"][case][1], results["sets"]["rf_X"],
                     carried=True)
        return
    for key in HEAP:
        if key == "gain" and FOREST[case][2].get("impurity") == "entropy":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def forest_ops(case):
    """The collectives of a forest fit: the layout's all-gather, the stream
    flag, a classifier's two label checks, the edge sample's gather, and one
    all-reduce a level of every tree."""
    kind = FOREST[case][0]
    return 2 + (2 if kind == "classifier" else 0) + 1 + worker.RF_TREES * worker.RF_DEPTH


@pytest.mark.parametrize("world,case", FOREST_CALLS)
def test_the_forest_collectives_are_the_paths(results, world, case):
    comm = [r["forest"][case]["comm"] for r in results["jobs"][world]]
    assert all(c == comm[0] for c in comm)
    assert comm[0]["comm.collective_ops"] == forest_ops(case)


@pytest.mark.parametrize("world,case", FOREST_CALLS)
def test_the_forest_transform_stays_on_each_rank(results, world, case):
    preds = []
    for r, res in enumerate(results["jobs"][world]):
        got = res["forest"][case]
        assert got["transform_comm"]["comm.collective_ops"] == 0
        lo, hi = _cuts(N_RF, world)[r : r + 2]
        assert (got["prediction"] is None) == (hi == lo)
        if got["prediction"] is not None:
            preds.append(got["prediction"])
    if _exact(case):
        np.testing.assert_array_equal(np.concatenate(preds), results["one"]["forest"][case][2])


@pytest.mark.parametrize("world,case,error", [
    (w, c, e) for w in WORLDS for c, e in (("negative_on_last_rank", "ValueError"),
                                           ("class_missing_everywhere", "RuntimeError"))])
def test_a_bad_label_raises_on_every_rank(results, world, case, error):
    """A negative label on one rank, a class on no rank: every rank raises
    after the same label collectives (two at most), and none hangs."""
    comm = [r["errors"][case]["comm"] for r in results["jobs"][world]]
    assert all(r["errors"][case]["raised"] == error for r in results["jobs"][world])
    assert all(c == comm[0] for c in comm)
    assert comm[0]["comm.collective_ops"] == 2 + (1 if error == "ValueError" else 2)


def test_the_worlds_are_ragged_and_the_middle_rank_is_empty():
    assert _cuts(N_ITEMS, 2) == [0, 1800, N_ITEMS]
    assert _cuts(N_RF, 3) == [0, 2400, 2400, N_RF]
    assert _cuts(N_QUERIES, 3, True) == [0, N_QUERIES, N_QUERIES, N_QUERIES]
