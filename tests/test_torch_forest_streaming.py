"""PyTorch port, the streamed (out-of-core) random forests
(spark_rapids_ml_torch/ops/trees.py::streaming_forest_fit, the estimators'
_streaming_fit) on the CPU, against the JAX package's streamed fit
(ops/trees.py::streaming_forest_fit, reached through its estimators under the
same stream_threshold_bytes and stream_batch_rows) and against the port's own
in-core growth, on numpy inputs made from a seed. The port's per-level
feature scores are the JAX package's jax.random scores, replayed through
ops/trees.py::_feature_scores (tests/test_torch_random_forest.py).

Tolerances: edges, uint8 bins and the classifier's heap arrays bit for bit
(integer histogram sums; the entropy gains within 1e-6, XLA's CPU log against
torch's, as in tests/test_torch_trees.py); under real-valued row weights the
splits equal and the values, gains and node weights within rtol 1e-5, atol
1e-6 (the weighted sums are added in another order, on data with no near
tie between splits); the regressor bit for bit on
integer labels, and on real labels its predictions within rtol 1e-5, atol
1e-5 · max |y| (its w y and w y^2 sums are added in another order).

Across processes (tests/_torch_mp_worker.py, job "forest_streaming"): two
ranks 60/40, and three whose middle rank holds no rows, each fitting its own
rows out-of-core; every case equal bit for bit to the one-process streamed fit
(classifier stats and integer regression labels: every bin sum is an integer
below 2^24), edges included; one case with more than 400,000 rows, so the
edge sample takes every second global row and the ranks' first sampled rows
differ."""

import fcntl
import os
import pickle
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import _torch_mp_worker as worker
import spark_rapids_ml_tpu.config as jax_config
from spark_rapids_ml_tpu.classification import RandomForestClassifier as JaxRFC
from spark_rapids_ml_tpu.ops import trees as jax_trees
from spark_rapids_ml_tpu.regression import RandomForestRegressor as JaxRFR
from spark_rapids_ml_torch import config
from spark_rapids_ml_torch.classification import RandomForestClassifier
from spark_rapids_ml_torch.models import tree as tree_model
from spark_rapids_ml_torch.ops import ingest, trees
from spark_rapids_ml_torch.regression import RandomForestRegressor
from spark_rapids_ml_torch.utils import record_spans

REPO = Path(__file__).resolve().parents[1]
HEAP = ("feature", "threshold", "is_leaf", "value", "gain", "node_weight", "bin_edges")
BATCH_ROWS = 700
WORLDS = (2, 3)
CHILD_TIMEOUT = 300


@pytest.fixture(autouse=True)
def restore_config():
    yield
    for key in ("stream_threshold_bytes", "stream_batch_rows", "device"):
        config.unset(key)
    for key in ("stream_threshold_bytes", "stream_batch_rows"):
        jax_config.unset(key)


def _stream(batch_rows=BATCH_ROWS):
    for cfg in (config, jax_config):
        cfg.set("stream_threshold_bytes", 1000)
        cfg.set("stream_batch_rows", batch_rows)


def _jax_scores(seed, n_trees, depth, d):
    """The JAX package's per-level scores, in draw order."""
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
        it = iter(_jax_scores(seed, n_trees, depth, d))
        monkeypatch.setattr(
            trees, "_feature_scores", lambda gen, w, dd, dev: torch.from_numpy(next(it)).to(dev))

    return install


def _data(n=3000, d=6, seed=0):
    """Features, 2- and 3-class labels, integer and real regression labels,
    row weights."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    score = X[:, 0] + 0.5 * X[:, 1] - 0.25 * X[:, 2] + rng.normal(0, 0.5, n)
    yreal = (2.0 * X[:, 0] - X[:, 1] + 0.3 * rng.normal(size=n)).astype(np.float32)
    return {
        "X": X,
        "y2": (score > 0).astype(np.float64),
        "y3": np.digitize(score, np.quantile(score, [1 / 3, 2 / 3])).astype(np.float64),
        "yint": np.round(yreal).astype(np.float64),
        "yreal": yreal.astype(np.float64),
        "w": rng.uniform(0.5, 2.0, n).astype(np.float64),
    }


def _frame(data, label, rows=slice(None)):
    return pd.DataFrame({"features": list(data["X"][rows]), "label": data[label][rows],
                         "w": data["w"][rows]})


def _fit_both(est, jax_est, frame, params, replay):
    _stream()
    jax_model = jax_est(num_workers=1, **params).fit(frame)
    replay(params.get("seed", 0), params["numTrees"], params["maxDepth"],
           len(frame["features"].iloc[0]))
    return est(device="cpu", **params).fit(frame), jax_model


def _spy(monkeypatch, module, name):
    calls, real = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("params,label", [
    (dict(numTrees=3, maxDepth=4, seed=1), "y2"),
    (dict(numTrees=2, maxDepth=5, impurity="entropy", maxBins=8, seed=2), "y3"),
    (dict(numTrees=3, maxDepth=3, bootstrap=False, subsamplingRate=0.6, seed=3), "y2"),
    (dict(numTrees=2, maxDepth=4, weightCol="w", seed=4), "y3"),
])
def test_streamed_classifier_equals_the_jax_streamed_fit(params, label, replay_scores,
                                                         monkeypatch):
    data = _data()
    streamed = _spy(monkeypatch, tree_model, "streaming_forest_fit")
    model, jax_model = _fit_both(RandomForestClassifier, JaxRFC, _frame(data, label), params,
                                 replay_scores)
    assert len(streamed) == 1
    got, want = model.get_model_attributes(), jax_model.get_model_attributes()
    for key in HEAP:
        if key in ("value", "gain", "node_weight") and "weightCol" in params:
            # real-valued stats: sums in another order (module header)
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
        elif key == "gain" and params.get("impurity") == "entropy":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert got["num_classes"] == want["num_classes"]


@pytest.mark.parametrize("label", ["yint", "yreal"])
def test_streamed_regressor_equals_the_jax_streamed_fit(label, replay_scores):
    data = _data(seed=5)
    params = dict(numTrees=3, maxDepth=4, seed=6)
    frame = _frame(data, label)
    model, jax_model = _fit_both(RandomForestRegressor, JaxRFR, frame, params, replay_scores)
    got, want = model.get_model_attributes(), jax_model.get_model_attributes()
    np.testing.assert_array_equal(got["bin_edges"], np.asarray(want["bin_edges"]))
    if label == "yint":
        for key in HEAP:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    pred = model.transform(frame)["prediction"].to_numpy()
    want_pred = jax_model.transform(frame)["prediction"].to_numpy()
    np.testing.assert_allclose(pred, want_pred, rtol=1e-5,
                               atol=1e-5 * float(np.abs(data[label]).max()))


def test_streamed_fit_grows_the_in_core_forest_from_its_bins(monkeypatch):
    """The resident bins are bin_features(X, edges) bit for bit, the growth
    is grow_forest's run in-core from them, and at n <= 200,000 (every row
    sampled) the streamed fit is the in-core fit bit for bit."""
    data = _data(seed=7)
    frame = _frame(data, "y3")
    params = dict(numTrees=3, maxDepth=4, seed=8)
    want = RandomForestClassifier(device="cpu", **params).fit(frame).get_model_attributes()
    grown = _spy(monkeypatch, trees, "grow_forest")
    stages = _spy(monkeypatch, tree_model, "stage")
    blocks = _spy(monkeypatch, ingest, "stage_block")
    _stream()
    with record_spans() as spans:
        model = RandomForestClassifier(device="cpu", **params).fit(frame)
    got = model.get_model_attributes()
    for key in HEAP:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # nothing (n, d) staged: the label and the weights, then X batch by batch
    assert [np.shape(args[0]) for args, _ in stages] == [(3000,), (3000,)]
    rows = [args[2] - args[1] for args, _ in blocks]
    assert max(rows) == BATCH_ROWS and sum(rows) == 3000
    assert {"bin", "stream.ingest", "bootstrap", "histogram", "route"} <= set(spans)
    (args, kwargs), = grown
    Xb, stats, edges = args[:3]
    assert Xb.dtype == torch.uint8 and Xb.shape == (3000, 6)
    assert torch.equal(Xb, trees.bin_features(torch.from_numpy(data["X"]), torch.from_numpy(edges)))
    again = trees.grow_forest(Xb.clone(), stats.clone(), edges, *args[3:], **kwargs)
    for key in HEAP:
        np.testing.assert_array_equal(again[key], got[key], err_msg=key)


def test_strided_edges_and_bins_equal_the_jax_streamed_fit():
    """450,003 rows: every second row sampled, then the 200,000-row draw of
    quantile_bin_edges on that sample; a one-tree fit of both packages."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(450_003, 3)).astype(np.float32)
    y = (X[:, 0] > 0.2).astype(np.float32)
    stats = np.stack([1.0 - y, y], axis=1).astype(np.float32)
    sample = trees.strided_sample(X)
    np.testing.assert_array_equal(sample.numpy(), X[::2])
    common = dict(n_trees=1, max_depth=2, max_bins=16, impurity="gini", feature_subset=3,
                  min_instances=1, min_info_gain=0.0, subsampling_rate=1.0, bootstrap=True,
                  seed=10, batch_rows=100_000)
    got = trees.streaming_forest_fit(X, torch.from_numpy(stats), device=torch.device("cpu"),
                                     **common)
    want = jax_trees.streaming_forest_fit(X, stats, **common)
    edges = jax_trees.quantile_bin_edges(np.ascontiguousarray(X[::2]), 16, seed=10)
    np.testing.assert_array_equal(got["bin_edges"], edges)
    np.testing.assert_array_equal(
        trees.bin_features(torch.from_numpy(X[:5000]), torch.from_numpy(edges)).numpy(),
        jax_trees.bin_features(X[:5000], edges).astype(np.uint8))
    for key in HEAP:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def test_max_bins_above_256_warns_and_fits_in_core(monkeypatch):
    data = _data(n=1500, seed=11)
    frame = _frame(data, "y2")
    params = dict(numTrees=2, maxDepth=3, maxBins=300, featureSubsetStrategy="all", seed=12)
    want = RandomForestClassifier(device="cpu", **params).fit(frame).get_model_attributes()
    streamed = _spy(monkeypatch, tree_model, "streaming_forest_fit")
    _stream()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = RandomForestClassifier(device="cpu", **params).fit(frame).get_model_attributes()
    assert streamed == []
    for key in HEAP:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with pytest.raises(ValueError, match="maxBins must be <= 256"):
        trees.streaming_forest_fit(data["X"], torch.zeros((1500, 2)), 1, 2, 300, "gini", 6, 1,
                                   0.0, 1.0, True, 0, 100, torch.device("cpu"))


# ---------------------------------------------------------------- across ranks


def _cuts(n, world):
    cut = int(0.6 * n)
    return [0, cut, n] if world == 2 else [0, cut, cut, n]


def _mp_sets():
    sets = {}
    for name, n, d, seed in (("fs", 3000, 6, 13), ("fsbig", 450_003, 3, 14)):
        for key, a in _data(n, d, seed).items():
            sets[f"{name}_{key}"] = a
    sets["fs_scores_3"] = np.concatenate(
        _jax_scores(worker.FS_SEED, worker.FS_TREES, worker.FS_DEPTH, 6))
    sets["fsbig_scores_1"] = np.concatenate(_jax_scores(worker.FS_SEED, 1, 2, 3))
    return sets


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_job(world, workdir, sets):
    workdir.mkdir(parents=True, exist_ok=True)
    cuts = {f"{name}_cuts": np.array(_cuts(len(sets[f"{name}_X"]), world))
            for name in ("fs", "fsbig")}
    np.savez(workdir / "data.npz", **sets, **cuts)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_mp_worker.py"), str(r), str(world),
         str(port), str(workdir), "forest_streaming"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _one_process(sets):
    """case -> model attributes of the one-process streamed fit."""
    out = {}
    real = trees._feature_scores
    config.set("device", "cpu")
    config.set("stream_threshold_bytes", 1)
    config.set("stream_batch_rows", worker.FS_BATCH_ROWS)
    try:
        for case, (kind, name, label, params) in worker.streamed_forest_cases().items():
            worker.replay(trees, worker.jax_score_list(
                sets[f"{name}_scores_{params['numTrees']}"], params["numTrees"],
                params["maxDepth"], sets[f"{name}_X"].shape[1]))
            frame = pd.DataFrame({"features": list(sets[f"{name}_X"]),
                                  "label": sets[f"{name}_{label}"], "w": sets[f"{name}_w"]})
            out[case] = worker.forest_estimator(kind, params).fit(frame).get_model_attributes()
    finally:
        trees._feature_scores = real
        for key in ("device", "stream_threshold_bytes", "stream_batch_rows"):
            config.unset(key)
    return out


def _compute(root):
    sets = _mp_sets()
    procs = {world: _run_job(world, root / f"world{world}", sets) for world in WORLDS}
    one = _one_process(sets)
    jobs = {}
    for world, ps in procs.items():
        outs = []
        try:
            for p in ps:
                outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
        finally:
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, out) in enumerate(zip(ps, outs)):
            assert p.returncode == 0, f"world {world} rank {r} failed:\n{out[-4000:]}"
        jobs[world] = []
        for r in range(world):
            with open(root / f"world{world}" / f"rank{r}.pkl", "rb") as f:
                jobs[world].append(pickle.load(f))
    return {"one": one, "jobs": jobs}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both jobs and the one-process fits, computed once for all xdist workers
    (the first to take the lock computes; the others read its file)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    root = root / "torch_forest_streaming"
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


@pytest.mark.parametrize("world,case", [(w, c) for w in WORLDS
                                        for c in worker.streamed_forest_cases()])
def test_streamed_forest_across_ranks_equals_one_process(results, world, case):
    want = results["one"][case]
    ranks = results["jobs"][world]
    for r, res in enumerate(ranks):
        assert res["process_index"] == r and res["process_count"] == world
        got = res["forest"][case]["attrs"]
        for key in HEAP:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"rank {r} {key}")
        # every rank, the empty one too, made the same collectives
        assert res["forest"][case]["comm"]["comm.collective_ops"] == \
            ranks[0]["forest"][case]["comm"]["comm.collective_ops"] > 0
