"""PyTorch port, the multi-process main path on the CPU: PCA, KMeans and
LinearRegression across the ranks of one gloo process group
(parallel/bootstrap.py, parallel/partitioner.py), each rank fitting its own
partition of the rows (tests/_torch_mp_worker.py), in-core and streamed at
48- and 1,024-row batches (split across the ranks).

Jobs: 2 ranks with a 60/40 ragged split, and 3 ranks whose middle rank holds
no rows. Data: 5,003 x 6 blobs (4 centers from N(0, 10²), unit noise), a
label y = X·(1..6) + 2 + N(0, 0.5²) and a weight from U(0.5, 2); and the two
rank-deficient designs of 3,001 x 7 (column 3 constant, column 4 a copy of
column 5; y = X·(1..7) + 0.1·N(0, 1)). Each world runs as one spawned job,
made once for all xdist workers (`results`); every child runs under a
timeout, and the group under its own.

Tolerances:
  * across ranks: the same bits (every attribute);
  * against the 1-process port fit of the concatenation, whose sums add in
    another order: PCA's explained variance and singular values rtol 1e-5,
    components and mean atol 1e-5; KMeans from the same initial centers
    (equal bit for bit: the 5,003 rows are below the init sample's 262,144,
    so the sample is all of X) the same n_iter, centers atol 1e-5 of the
    data's rms and inertia rtol 1e-5; LinearRegression's coefficients and
    intercept within 2e-4 of the largest coefficient, the JAX parity
    tolerance (the blobs' standardized normal matrix has a condition number
    of 183, so f32 sums in another order move the solution by up to 1e-4 of
    it; the 1,024-row streamed fits of tests/test_torch_streaming.py, whose
    data is better conditioned, hold 1e-5);
  * against the JAX package's single-process fit of the concatenation, at
    the in-core parity tests' tolerances: PCA as tests/test_torch_pca.py
    (mean rtol 1e-5, components' dot >= 1 - 1e-5, variances rtol 1e-4),
    LinearRegression as tests/test_torch_linear.py (2e-4 of the largest
    coefficient), KMeans the JAX package's lloyd_fit from the same initial
    centers (the same n_iter, centers atol 1e-4, inertia rtol 1e-4; its
    k-means|| noise comes from another generator, so its own init is not
    comparable);
  * rank-deficient OLS against numpy's f64 minimum-norm lstsq of the
    centered, standardized design (a constant column has coefficient 0):
    coefficients within 1e-4 absolute (1e-5 of the largest), training RMSE
    within 5% of the 0.1 noise;
  * the collectives: every rank counts the same operations and bytes, and
    the operations are exactly the path's (`expected_ops`)."""

import fcntl
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import _torch_mp_worker as worker
from spark_rapids_ml_tpu.ops import kmeans as jax_kmeans
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinearRegression
import spark_rapids_ml_tpu.feature as jax_feature
from spark_rapids_ml_torch import config
from spark_rapids_ml_torch.ops import kmeans as torch_kmeans

REPO = Path(__file__).resolve().parents[1]
N_BLOBS, D_BLOBS = 5003, 6
N_RD, D_RD = 3001, 7
WORLDS = (2, 3)
CASES = tuple(worker.cases())
KMEANS = tuple(c for c in CASES if c.startswith("kmeans"))
RANK_DEFICIENT = tuple(c for c in CASES if "constant" in c or "duplicate" in c)
MODES = tuple(worker.modes())
# the LinearRegression cases of the blobs, as _torch_mp_worker.cases() sets them
LINREG_PARAMS = {"ols": {}, "ridge": {"regParam": 0.1},
                 "elastic_net": {"regParam": 0.01, "elasticNetParam": 0.5},
                 "ols_weighted": {"weightCol": "w"}}
CHILD_TIMEOUT = 600


def _cuts(n, world):
    """60/40 on 2 ranks; on 3 the middle rank holds no rows."""
    cut = int(0.6 * n)
    return [0, cut, n] if world == 2 else [0, cut, cut, n]


def _data_sets():
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 10, (4, D_BLOBS))
    X = (centers[rng.integers(0, 4, N_BLOBS)] + rng.normal(0, 1, (N_BLOBS, D_BLOBS))).astype(np.float32)
    y = (X @ np.arange(1.0, D_BLOBS + 1) + 2 + rng.normal(0, 0.5, N_BLOBS)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, N_BLOBS).astype(np.float32)
    sets = {"blobs": {"X": X, "y": y, "w": w}}
    for design in ("constant", "duplicate"):
        Xr = np.random.default_rng(0).normal(size=(N_RD, D_RD)).astype(np.float32)
        if design == "constant":
            Xr[:, 3] = 1.0
        else:
            Xr[:, 4] = Xr[:, 5]
        yr = (Xr @ np.arange(1.0, D_RD + 1) + 0.1 * np.random.default_rng(1).normal(size=N_RD)
              ).astype(np.float32)
        wr = np.random.default_rng(2).uniform(0.5, 2.0, N_RD).astype(np.float32)
        sets[design] = {"X": Xr, "y": yr, "w": wr}
    return sets


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_job(world, workdir, sets):
    """One spawned job of `world` ranks; each rank's results."""
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "data.npz", **{
        f"{name}_{key}": value for name, s in sets.items()
        for key, value in [*s.items(), ("cuts", np.array(_cuts(len(s["X"]), world)))]})
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_mp_worker.py"), str(r), str(world),
         str(port), str(workdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return procs


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


def _one_process_fits(sets):
    """(mode, case) -> (attributes, initial centers) of the port's
    single-process fit of all the rows."""
    inits = []
    real_init = torch_kmeans.kmeans_init

    def recorded_init(*args):
        centers = real_init(*args)
        inits.append(np.asarray(centers).copy())
        return centers

    out = {}
    torch_kmeans.kmeans_init = recorded_init
    try:
        config.set("device", "cpu")
        for mode, batch_rows in worker.modes().items():
            config.set("stream_threshold_bytes", 1 if batch_rows else 0)
            config.set("stream_batch_rows", batch_rows or 1 << 20)
            for case, (name, make, kind) in worker.cases().items():
                inits.clear()
                data = dict(sets[name], cuts=[0, len(sets[name]["X"])])
                model = make().fit(worker._input(data, kind, 0))
                out[(mode, case)] = (model.get_model_attributes(), inits[0] if inits else None)
    finally:
        torch_kmeans.kmeans_init = real_init
        for key in ("device", "stream_threshold_bytes", "stream_batch_rows"):
            config.unset(key)
    return out


def _compute(root):
    sets = _data_sets()
    procs = {world: _run_job(world, root / f"world{world}", sets) for world in WORLDS}
    one = _one_process_fits(sets)
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
    """Both jobs and the 1-process fits, computed once for all xdist workers
    (the first worker to take the lock computes; the others read its file)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers' common parent
        root = root.parent
    root = root / "torch_multiprocess"
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


def _set_of(case):
    return "constant" if "constant" in case else "duplicate" if "duplicate" in case else "blobs"


def _full(results, case):
    s = results["sets"][_set_of(case)]
    return s["X"], s["y"], s["w"]


def _bits_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bits_equal(a[k], b[k]) for k in a)
    if a is None or b is None:
        return a is b
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _close_lr(got, want, rtol):
    scale = np.abs(want["coefficients"]).max()
    np.testing.assert_allclose(got["coefficients"], want["coefficients"], rtol=rtol, atol=rtol * scale)
    np.testing.assert_allclose(got["intercept"], want["intercept"], rtol=rtol, atol=rtol * scale)


ALL = [(world, mode, case) for world in WORLDS for mode in MODES for case in CASES]


@pytest.mark.parametrize("world,mode,case", ALL)
def test_every_rank_returns_the_same_bits(results, world, mode, case):
    ranks = results["jobs"][world]
    assert [r["process_index"] for r in ranks] == list(range(world))
    assert all(r["process_count"] == world for r in ranks)
    first = ranks[0][(mode, case)]
    for r in ranks[1:]:
        assert _bits_equal(r[(mode, case)]["attrs"], first["attrs"])
        assert _bits_equal(r[(mode, case)]["init"], first["init"])


@pytest.mark.parametrize("world,mode,case", ALL)
def test_the_model_matches_the_one_process_port_fit(results, world, mode, case):
    got = results["jobs"][world][0][(mode, case)]["attrs"]
    want, _ = results["one"][(mode, case)]
    if case == "pca":
        for attr in ("explained_variance", "singular_values"):
            np.testing.assert_allclose(got[attr], want[attr], rtol=1e-5)
        np.testing.assert_allclose(got["components"], want["components"], atol=1e-5)
        np.testing.assert_allclose(got["mean"], want["mean"], atol=1e-5)
    elif case in KMEANS:
        X = _full(results, case)[0]
        rms = float(np.sqrt(np.mean(X.astype(np.float64) ** 2)))
        assert got["n_iter"] == want["n_iter"]
        np.testing.assert_allclose(got["cluster_centers"], want["cluster_centers"], atol=1e-5 * rms)
        assert got["inertia"] == pytest.approx(want["inertia"], rel=1e-5)
        if mode == "in-core":
            np.testing.assert_array_equal(got["cluster_sizes"], want["cluster_sizes"])
        else:
            assert got["cluster_sizes"] is None and want["cluster_sizes"] is None
    else:
        _close_lr(got, want, 2e-4)


@pytest.mark.parametrize("world,mode,case", [(w, m, c) for w, m, c in ALL if c in KMEANS])
def test_initial_centers_equal_the_one_process_fit_bit_for_bit(results, world, mode, case):
    got = results["jobs"][world][0][(mode, case)]["init"]
    _, want = results["one"][(mode, case)]
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want.astype(got.dtype))
    assert got.dtype == np.float32 and got.shape == (4, D_BLOBS)


@pytest.fixture(scope="module")
def jax_fits(results):
    """The JAX package's single-process in-core PCA and LinearRegression fits of
    the blobs."""
    X, y, w = _full(results, "pca")
    df = pd.DataFrame({"features": list(X), "label": y, "w": w})
    fits = {"pca": jax_feature.PCA(k=3, inputCol="features").fit(X)}
    for case, params in LINREG_PARAMS.items():
        fits[case] = JaxLinearRegression(**params).fit(df)
    return fits


@pytest.mark.parametrize("world,mode,case", [(w, m, c) for w, m, c in ALL
                                             if c not in RANK_DEFICIENT])
def test_the_model_matches_the_jax_single_process_fit(results, jax_fits, world, mode, case):
    import jax.numpy as jnp

    entry = results["jobs"][world][0][(mode, case)]
    got = entry["attrs"]
    if case == "pca":
        want = jax_fits["pca"]
        np.testing.assert_allclose(got["mean"], want.mean, rtol=1e-5)
        dots = np.sum(got["components"].astype(np.float64) * want.components_, axis=1)
        assert np.all(dots >= 1 - 1e-5), dots
        np.testing.assert_allclose(got["explained_variance"], want.explained_variance_, rtol=1e-4)
        np.testing.assert_allclose(got["singular_values"], want.singular_values_, rtol=1e-4)
    elif case in KMEANS:
        X, _, w = _full(results, case)
        wv = w if "weighted" in case else np.ones_like(w)
        centers, inertia, n_iter = jax_kmeans.lloyd_fit(
            jnp.asarray(X), jnp.asarray(wv), jnp.asarray(entry["init"]), 1e-4, 20)
        assert got["n_iter"] == int(n_iter)
        np.testing.assert_allclose(got["cluster_centers"], np.asarray(centers), atol=1e-4)
        assert got["inertia"] == pytest.approx(float(inertia), rel=1e-4)
    else:
        want = jax_fits[case]
        _close_lr(got, {"coefficients": want.coefficients, "intercept": want.intercept}, 2e-4)


def expected_ops(mode, case, attrs):
    """The collectives of one fit on every rank: the descriptor's all-gather
    and the stream flag's all-reduce, then PCA's and LinearRegression's one
    all-reduce of the statistics; KMeans's init (two gathers of two
    collectives each, the broadcast), one all-reduce a Lloyd step or pass,
    and in-core the final inertia and the cluster sizes; LinearRegression's
    second, the all-reduce MAX of its column ranges."""
    if case in KMEANS:
        fit = 5 + attrs["n_iter"] + (2 if mode == "in-core" else 0)
    elif case == "pca":
        fit = 1
    else:
        fit = 2
    return 2 + fit


@pytest.mark.parametrize("world,mode,case", ALL)
def test_the_collectives_are_the_paths(results, world, mode, case):
    ranks = results["jobs"][world]
    comm = [r[(mode, case)]["comm"] for r in ranks]
    attrs = ranks[0][(mode, case)]["attrs"]
    assert all(c == comm[0] for c in comm)
    assert comm[0]["comm.collective_ops"] == expected_ops(mode, case, attrs)
    assert comm[0]["comm.collective_bytes"] > 0


# ------------------------------------------------------------ rank-deficient OLS


def min_norm_reference(X, y, w):
    """Coefficients and intercept of numpy's f64 minimum-norm lstsq of the
    weighted, centered, standardized design (a constant column: coefficient
    0), in the original feature space."""
    X, y, w = X.astype(np.float64), y.astype(np.float64), w.astype(np.float64)
    mu = (w[:, None] * X).sum(0) / w.sum()
    yb = (w * y).sum() / w.sum()
    Xc = X - mu
    Xc[:, np.ptp(X, axis=0) == 0] = 0.0
    sd = np.sqrt((w[:, None] * Xc**2).sum(0) / (w.sum() - 1))
    sd[sd <= 0] = 1.0
    sw = np.sqrt(w)
    coef = np.linalg.lstsq((Xc / sd) * sw[:, None], (y - yb) * sw, rcond=None)[0] / sd
    return coef, yb - mu @ coef


def check_min_norm(attrs, X, y, w):
    coef, icpt = min_norm_reference(X, y, w)
    np.testing.assert_allclose(attrs["coefficients"], coef, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(attrs["intercept"], icpt, atol=1e-4)
    pred = X.astype(np.float64) @ attrs["coefficients"] + attrs["intercept"]
    rmse = float(np.sqrt(np.sum(w * (pred - y) ** 2) / np.sum(w)))
    assert rmse == pytest.approx(0.1, rel=0.05)


ROUTES = ["1 process", "2 ranks", "3 ranks"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", RANK_DEFICIENT)
def test_rank_deficient_ols_is_the_minimum_norm_solution(results, case, mode, route):
    X, y, w = _full(results, case)
    wv = w if case.endswith("weighted") else np.ones_like(w)
    if route == "1 process":
        attrs = results["one"][(mode, case)][0]
    else:
        attrs = results["jobs"][int(route[0])][0][(mode, case)]["attrs"]
    check_min_norm(attrs, X, y, wv)
    if "constant" in case:
        assert attrs["coefficients"][3] == 0.0
    else:
        assert attrs["coefficients"][4] == pytest.approx(attrs["coefficients"][5], rel=1e-4)


@pytest.mark.parametrize("design", ["constant", "duplicate"])
def test_the_jax_package_solves_rank_deficient_ols_differently(results, design):
    """The JAX package solves the singular normal equations as they are: a
    huge coefficient for the constant column, NaN or an arbitrary split for
    the duplicated pair, where the port gives the minimum-norm answer."""
    s = results["sets"][design]
    df = pd.DataFrame({"features": list(s["X"]), "label": s["y"]})
    coef = np.asarray(JaxLinearRegression().fit(df).coefficients, np.float64)
    want, _ = min_norm_reference(s["X"], s["y"], np.ones_like(s["w"]))
    # NaN, or off the minimum-norm answer (4e8 for the constant column; the
    # duplicated pair split some other way)
    assert not np.allclose(coef, want, atol=1e-2), coef
    if design == "constant":
        assert not np.isfinite(coef[3]) or abs(coef[3]) > 1e3, coef
    port = results["one"][("in-core", f"ols_{design}")][0]["coefficients"]
    np.testing.assert_allclose(port, want, atol=1e-4)


def test_the_worlds_are_ragged_and_the_middle_rank_is_empty():
    assert _cuts(N_BLOBS, 2) == [0, 3001, N_BLOBS]
    assert _cuts(N_BLOBS, 3) == [0, 3001, 3001, N_BLOBS]


def test_a_lost_rank_fails_the_fit_on_the_others(tmp_path):
    """Rank 1 joins the group and exits; rank 0's fit raises within the
    group's timeout instead of hanging or fitting alone."""
    code = (
        "import datetime, os, sys\n"
        "import numpy as np\n"
        "from spark_rapids_ml_torch import config\n"
        "from spark_rapids_ml_torch.feature import PCA\n"
        "from spark_rapids_ml_torch.parallel import bootstrap\n"
        "config.set('device', 'cpu')\n"
        "bootstrap.init_from_env(timeout=datetime.timedelta(seconds=20))\n"
        "if os.environ['SRML_TPU_PROCESS_ID'] == '1':\n"
        "    sys.exit(0)\n"
        "try:\n"
        "    PCA(k=2, inputCol='features').fit(np.ones((10, 3), np.float32))\n"
        "except Exception as e:\n"
        "    print('FIT FAILED', type(e).__name__)\n"
        "    sys.exit(3)\n"
        "print('FIT RAN')\n"
    )
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), SRML_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   SRML_TPU_NUM_PROCESSES="2", SRML_TPU_PROCESS_ID=str(r))
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=tmp_path,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert procs[1].returncode == 0, outs[1][-3000:]
    assert procs[0].returncode == 3 and "FIT FAILED" in outs[0], outs[0][-3000:]


def test_no_process_group_means_one_rank_and_no_collective():
    from spark_rapids_ml_torch.parallel import partitioner

    part = partitioner.active_partitioner()
    assert (part.process_index, part.process_count, part.is_multiprocess) == (0, 1, False)
    partitioner.reset_counters()
    t = torch.arange(3.0)
    assert part.all_reduce_sum(t)[0] is t
    assert part.any(True) and not part.any(False)
    assert part.all_gather_rows(t) is t
    desc = part.descriptor(7, 3)
    assert (desc.m, desc.n, desc.offset, desc.padded_m) == (7, 3, 0, 7)
    assert partitioner.counters["comm.collective_ops"] == 0
