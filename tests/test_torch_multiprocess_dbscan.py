"""PyTorch port, DBSCAN across the ranks of one gloo process group on the CPU
(ops/dbscan.py's ring, models/dbscan.py), each rank passing its own rows to
transform() (tests/_torch_mp_worker.py, job "dbscan").

Jobs: 2 ranks with a 60/40 ragged split, and 3 ranks whose middle rank holds
no rows, run once per session and shared by the xdist workers through a file
lock. Data (numpy, seed 0), each set's rows shuffled, so every cluster's rows
lie on every rank with rows:
  * "blobs": 3,000 x 5, five Gaussian blobs (sd 0.5, centers N(0, 5²)) and 5%
    uniform noise in [-12, 12]^5; eps 1.0, min_samples 8;
  * "cosine": 2,000 x 6, three directions (noise 0.05, magnitudes U(0.5, 4))
    and 10% normal rows; cosine eps 0.02, min_samples 6;
  * "chain": 200 points 1.0 apart on a line (jitter 0.05 in 3 more columns),
    eps 1.5, min_samples 2: one cluster that takes 44 propagation rounds;
  * "long_chain": the same at 300 points, which the 64 rounds of both
    packages leave unconverged (three labels): the border pass then scans
    once more.

The borderline rule. The ranks count a pair of rows in another product shape
than one process does (a rank's rows against one shard a hop), so the f32
rounding of a pair's d2 may differ. A pair is borderline when its f64 d2 (of
the f32 rows the scan runs on) lies within BAND_ULPS x 2^-23 x (|a|² + |b|²)
of eps²: BAND_ULPS is chip_smoke.py's DB_BAND_ULPS, and
`test_the_band_covers_the_f32_d2_error` holds every pair's f32 d2, as the
port's scan and the JAX package's compute it, within half the band of f64.
Only a borderline pair may fall on either side of eps in either labeling.
So the ring's eps-counts, summed over its hops, equal one process's at every
row but a borderline pair's ends, and differ there by at most the row's
borderline pairs; a core flag may flip only at an end. Two labelings must be
equal as numbers at every row but the ends and the rows of a cluster, in
either labeling, holding a row whose core flag differs between them; and at
most MOVED_SHARE of the rows may differ. The tests count such rows.

Against the 1-process port's transform of all the rows, and the JAX
package's dbscan_fit_predict of them: the rule above (the JAX side scans in
XLA; its core mask is its `_core_mask` of the same rows). The ranks:
the same propagation rounds as one process, and the collectives of the ring
(`ring_ops`) with the same bytes on every rank. A per-rank DBSCAN of each
rank's rows alone gives other labels (the discriminating case). Errors (a
zero row under the cosine metric on the last rank, f64 features) raise on
every rank, each job under a timeout."""

import fcntl
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_mp_worker as worker
from spark_rapids_ml_torch import config
from spark_rapids_ml_torch.clustering import DBSCAN
from spark_rapids_ml_torch.ops import dbscan

REPO = Path(__file__).resolve().parents[1]
WORLDS = (2, 3)
CHILD_TIMEOUT = 300
CASES = worker.dbscan_cases()
BAND_ULPS = 16.0  # chip_smoke.py's DB_BAND_ULPS
MOVED_SHARE = 1e-3  # chip_smoke.py's DB_MOVED_SHARE
MAX_ROUNDS = 64  # dbscan_fit_predict's default, in both packages


def _cuts(n, world):
    """60/40 on 2 ranks; on 3 the middle rank holds no rows."""
    cut = int(0.6 * n)
    return [0, cut, n] if world == 2 else [0, cut, cut, n]


def _data_sets():
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 5, (5, 5))
    n_noise = 150
    blobs = np.concatenate([centers[rng.integers(0, 5, 3000 - n_noise)]
                            + rng.normal(0, 0.5, (3000 - n_noise, 5)),
                            rng.uniform(-12, 12, (n_noise, 5))])
    dirs = rng.normal(size=(3, 6))
    cosine = np.concatenate(
        [(dirs[i] + rng.normal(0, 0.05, (600, 6))) * rng.uniform(0.5, 4, (600, 1))
         for i in range(3)] + [rng.normal(size=(200, 6))])
    chains = {}
    for name, n in (("db_chain", 200), ("db_long_chain", 300)):
        chains[name] = np.zeros((n, 4))
        chains[name][:, 0] = np.arange(float(n))
        chains[name][:, 1:] = rng.normal(0, 0.05, (n, 3))
    sets = {}
    for name, X in (("db_blobs", blobs), ("db_cosine", cosine), *chains.items()):
        sets[name] = X[rng.permutation(len(X))].astype(np.float32)
    return sets


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_job(world, workdir, sets):
    workdir.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for name, X in sets.items():
        arrays[f"{name}_X"] = X
        arrays[f"{name}_cuts"] = np.array(_cuts(len(X), world))
    np.savez(workdir / "data.npz", **arrays)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_mp_worker.py"), str(r), str(world),
         str(port), str(workdir), "dbscan"],
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


def _one_process(sets):
    """case -> (labels, rounds) of the port's single-process transform of all
    the rows, and per world and case each rank's rows clustered alone."""
    from spark_rapids_ml_torch.parallel import partitioner

    out, alone = {}, {}
    config.set("device", "cpu")
    try:
        for case, (name, eps, min_samples, metric) in CASES.items():
            X = sets[name]
            model = DBSCAN(eps=eps, min_samples=min_samples, metric=metric).fit(X)
            rounds = dbscan._propagate_labels.rounds
            partitioner.reset_counters()
            labels = model.transform(X)["prediction"].to_numpy()
            assert partitioner.counters["comm.collective_ops"] == 0
            out[case] = (labels, dbscan._propagate_labels.rounds - rounds)
            for world in WORLDS:
                cuts = _cuts(len(X), world)
                alone[(world, case)] = [
                    model.transform(X[lo:hi])["prediction"].to_numpy() if hi > lo else None
                    for lo, hi in zip(cuts[:-1], cuts[1:])]
    finally:
        config.unset("device")
    return out, alone


def _compute(root):
    sets = _data_sets()
    procs = {world: _run_job(world, root / f"world{world}", sets) for world in WORLDS}
    one, alone = _one_process(sets)
    for world in WORLDS:
        _wait(procs[world])
    jobs = {}
    for world in WORLDS:
        jobs[world] = []
        for r in range(world):
            with open(root / f"world{world}" / f"rank{r}.pkl", "rb") as f:
                jobs[world].append(pickle.load(f))
    return {"sets": sets, "jobs": jobs, "one": one, "alone": alone}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both jobs and the 1-process transforms, computed once for all xdist
    workers (the first worker to take the lock computes; the others read its
    file)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):  # the workers' common parent
        root = root.parent
    root = root / "torch_multiprocess_dbscan"
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


# ------------------------------------------------------------ the borderline rule


def scan_rows(X, metric):
    """The f32 rows the port's euclidean scan runs on, and its eps²."""
    import torch

    rows, eps2 = dbscan._metric_rows(torch.from_numpy(X), torch.ones(len(X), dtype=torch.bool),
                                     *metric)
    return rows.numpy(), eps2


def band_pairs(X, metric):
    """Per row, the borderline pairs it ends (module header): `metric` is
    (eps, metric name)."""
    rows, eps2 = scan_rows(X, metric)
    X64 = rows.astype(np.float64)
    sq = (X64 * X64).sum(1)
    d2 = np.maximum(sq[:, None] - 2.0 * X64 @ X64.T + sq[None, :], 0.0)
    tol = BAND_ULPS * 2.0**-23 * (sq[:, None] + sq[None, :])
    return (np.abs(d2 - eps2) <= tol).sum(1)


def one_process_counts(X, metric):
    """The port's eps-counts of one process: every row against every row."""
    import torch

    rows, eps2 = scan_rows(X, metric)
    t = torch.from_numpy(rows)
    return dbscan.fused_count_below(t, t, torch.ones(len(X), dtype=torch.bool),
                                    eps2).numpy().astype(np.int64)


def cluster_keys(labels):
    """Each row's cluster id, a noise row its own (-1 - row)."""
    return np.where(labels >= 0, labels, -1 - np.arange(len(labels)))


def disagreeing_rows(a, b):
    """Bool mask of the rows whose cluster is not the same set of rows in
    labelings a and b."""
    ka, kb = cluster_keys(a), cluster_keys(b)
    _, ia, size_a = np.unique(ka, return_inverse=True, return_counts=True)
    _, ib, size_b = np.unique(kb, return_inverse=True, return_counts=True)
    _, pair, size_ab = np.unique(np.stack([ia, ib], 1), axis=0, return_inverse=True,
                                 return_counts=True)
    both = size_ab[pair.reshape(-1)]
    return (both != size_a[ia]) | (both != size_b[ib])


def assert_same_under_the_rule(got, want, ends, flipped):
    """got and want equal as numbers at every row but the `ends` of a
    borderline pair and the rows of a cluster, in either labeling, holding a
    row of `flipped` (core in one labeling only); at most MOVED_SHARE of the
    rows differ. Returns the rows that differ."""
    allowed = ends | flipped
    for labels in (got, want):
        keys = cluster_keys(labels)
        allowed |= np.isin(keys, keys[flipped])
    moved = got != want
    assert not (moved & ~allowed).any(), (
        f"{int((moved & ~allowed).sum())} rows out of the rule's reach take other labels")
    assert moved.sum() <= MOVED_SHARE * len(got), f"{int(moved.sum())} rows take other labels"
    return int(moved.sum())


def ring_labels(ranks, case):
    return np.concatenate([r["dbscan"][case]["labels"] for r in ranks])


def ring_ops(world, rounds, metric):
    """Collectives of one transform across `world` ranks in `rounds` rounds
    (ops/dbscan.py's header): the descriptor's all-gather, the count's
    shifts and the core flags' all-gather, each round's shifts and
    all-gather, the labels' all-gather, the cosine zero-row vote, and the
    border pass's shifts when the rounds ran out (MAX_ROUNDS)."""
    cut = (world - 1) if rounds == MAX_ROUNDS else 0
    return 1 + world + rounds * world + 1 + (metric == "cosine") + cut


# ------------------------------------------------------------------- tests


ALL = [(w, c) for w in WORLDS for c in CASES]


def _metric(case):
    _, eps, _, metric = CASES[case]
    return eps, metric


@pytest.mark.parametrize("world,case", ALL)
def test_labels_equal_the_single_process_port(results, world, case):
    name, _, min_samples, _ = CASES[case]
    X = results["sets"][name]
    got = ring_labels(results["jobs"][world], case)
    want, _ = results["one"][case]
    assert got.dtype == np.int64 and got.shape == want.shape
    counts = np.concatenate([r["dbscan"][case]["counts"] for r in results["jobs"][world]])
    flipped = (counts >= min_samples) != (one_process_counts(X, _metric(case)) >= min_samples)
    assert_same_under_the_rule(got, want, band_pairs(X, _metric(case)) > 0, flipped)
    assert got.max() >= 0 and ("chain" in case or (got == -1).any())


@pytest.mark.parametrize("world,case", ALL)
def test_the_ring_counts_equal_one_process_outside_the_band(results, world, case):
    """The eps-counts summed over the ring's hops against one process's, each
    row within its borderline pairs (none at most rows); a core flag flips
    only at a borderline pair's end."""
    name, _, min_samples, _ = CASES[case]
    X = results["sets"][name]
    got = np.concatenate([r["dbscan"][case]["counts"] for r in results["jobs"][world]])
    want = one_process_counts(X, _metric(case))
    near = band_pairs(X, _metric(case))
    assert got.shape == want.shape and (want >= 1).all()  # self included
    assert (np.abs(got - want) <= near).all()
    flipped = (got >= min_samples) != (want >= min_samples)
    assert not (flipped & (near == 0)).any()


@pytest.mark.parametrize("world,case", ALL)
def test_labels_equal_the_jax_package(results, world, case):
    import jax.numpy as jnp

    from spark_rapids_ml_tpu.ops import dbscan as jax_dbscan

    name, eps, min_samples, metric = CASES[case]
    X = results["sets"][name]
    valid = jnp.ones(len(X), bool)
    want = jax_dbscan.dbscan_fit_predict(jnp.asarray(X), valid, eps, min_samples, metric=metric)
    Xj = jnp.asarray(X)
    if metric == "cosine":
        Xj = Xj / jnp.maximum(jnp.linalg.norm(Xj, axis=1, keepdims=True), 1e-30)
    _, eps2 = scan_rows(X, _metric(case))
    core_jax = np.asarray(jax_dbscan._core_mask(Xj, valid, eps2, min_samples))
    counts = np.concatenate([r["dbscan"][case]["counts"] for r in results["jobs"][world]])
    got = ring_labels(results["jobs"][world], case)
    assert_same_under_the_rule(got, want, band_pairs(X, _metric(case)) > 0,
                               (counts >= min_samples) != core_jax)


@pytest.mark.parametrize("case", tuple(CASES))
def test_the_band_covers_the_f32_d2_error(case):
    """Every pair's d2 in f32, as the port's scan (ops/knn.py::_block_sq_dists)
    and the JAX package's (its ops/knn.py::_block_sq_dists, XLA) compute it,
    lies within half the band of its f64 value, so only a borderline pair can
    fall on both sides of eps²."""
    import jax.numpy as jnp
    import torch

    from spark_rapids_ml_torch.ops.knn import _block_sq_dists
    from spark_rapids_ml_tpu.ops import knn as jax_knn

    X = _data_sets()[CASES[case][0]]
    rows, _ = scan_rows(X, _metric(case))
    X64 = rows.astype(np.float64)
    sq = (X64 * X64).sum(1)
    d64 = np.maximum(sq[:, None] - 2.0 * X64 @ X64.T + sq[None, :], 0.0)
    unit = 2.0**-23 * (sq[:, None] + sq[None, :])
    t = torch.from_numpy(rows)
    port = _block_sq_dists(t, t, torch.sum(t * t, dim=1)).numpy()
    j = jnp.asarray(rows)
    jax_d2 = np.asarray(jax_knn._block_sq_dists(j, j, jnp.sum(j * j, axis=1)))
    for d2 in (port, jax_d2):
        assert float((np.abs(d2 - d64) / unit).max()) <= BAND_ULPS / 2


@pytest.mark.parametrize("world,case", ALL)
def test_every_rank_runs_the_single_process_rounds_and_the_ring_collectives(
        results, world, case):
    ranks = results["jobs"][world]
    metric = CASES[case][3]
    _, rounds = results["one"][case]
    for r in ranks:
        got = r["dbscan"][case]
        assert got["raised"] is None
        assert got["rounds"] == rounds
        assert got["comm"]["comm.collective_ops"] == ring_ops(world, rounds, metric)
        assert got["comm"] == ranks[0]["dbscan"][case]["comm"]


@pytest.mark.parametrize("case", tuple(CASES))
def test_the_empty_rank_returns_no_labels(results, case):
    empty = results["jobs"][3][1]["dbscan"][case]["labels"]
    assert empty.shape == (0,) and empty.dtype == np.int64


@pytest.mark.parametrize("world", WORLDS)
def test_a_per_rank_dbscan_gives_other_labels(results, world):
    """The discriminating case: each blob's rows lie on every rank, so each
    rank clustering its rows alone finds fewer core points, and more noise,
    than the group does."""
    ranks = results["jobs"][world]
    for r, alone in zip(ranks, results["alone"][(world, "blobs")]):
        if alone is None:
            continue
        got = r["dbscan"]["blobs"]["labels"]
        assert disagreeing_rows(alone, got).sum() > 0.1 * len(got)
        assert (alone == -1).sum() > (got == -1).sum()


def test_the_chains_take_many_rounds(results):
    labels, rounds = results["one"]["chain"]
    assert 20 <= rounds < MAX_ROUNDS and (labels == 0).all()
    labels, rounds = results["one"]["long_chain"]
    assert rounds == MAX_ROUNDS and labels.max() >= 1 and (labels >= 0).all()
    for world in WORLDS:
        for r in results["jobs"][world]:
            for case in ("chain", "long_chain"):
                assert r["dbscan"][case]["rounds"] == results["one"][case][1]


@pytest.mark.parametrize("case", tuple(worker.dbscan_errors()))
@pytest.mark.parametrize("world", WORLDS)
def test_errors_raise_on_every_rank(results, world, case):
    """A zero row under the cosine metric on the last rank: every rank raises
    ValueError after the descriptor's all-gather and the zero-row vote. f64
    features: every rank raises NotImplementedError at fit, before any
    collective."""
    want = worker.dbscan_errors()[case][2]
    ops = 2 if case == "zero_row" else 0
    for r in results["jobs"][world]:
        got = r["errors"][case]
        assert got["raised"] == want
        assert got["comm"]["comm.collective_ops"] == ops
