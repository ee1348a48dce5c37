"""PyTorch port, eps-neighbor count (spark_rapids_ml_torch/ops/count.py) and the
blocked distance scan under it (ops/knn.py): the plain versions, which the CPU
wrapper runs, against the JAX package's Pallas count kernel in interpret mode
(ops/pallas_select.py::fused_count_below) and its `_block_sq_dists`, on the same
numpy inputs.

Tolerance: counts are exact. eps² is placed between two neighboring pair
distances, at least 1e-5·(|q| + |x|)² from every pair's d2 (checked in f64),
so f32 rounding in either package cannot move a pair across it. Distances: rtol 1e-5,
atol 1e-5·max d2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import knn as jax_knn
from spark_rapids_ml_tpu.ops import pallas_select as jax_ps
from spark_rapids_ml_torch.ops import count, knn


def _points(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3, (4, d))
    return (centers[rng.integers(0, 4, n)] + rng.normal(0, 1, (n, d))).astype(np.float32)


def _d2_64(Q, X):
    Q, X = Q.astype(np.float64), X.astype(np.float64)
    return np.maximum((Q * Q).sum(1)[:, None] - 2 * Q @ X.T + (X * X).sum(1)[None, :], 0)


def _eps2_away_from_every_pair(Q, X, q):
    """eps² in the widest gap between neighboring pair distances near quantile
    q, and the check that every pair's d2 lies at least 1e-5·(|q| + |x|)² from
    it: some 170 f32 ulps of the terms d2 is computed from."""
    d2 = _d2_64(Q, X)
    v = np.unique(d2.ravel())
    i = np.searchsorted(v, np.quantile(v, q))
    lo = max(i - 2000, 0)
    j = lo + int(np.argmax(np.diff(v[lo : i + 2000])))
    eps2 = 0.5 * (v[j] + v[j + 1])
    qn = np.linalg.norm(Q.astype(np.float64), axis=1)
    xn = np.linalg.norm(X.astype(np.float64), axis=1)
    scale = (qn[:, None] + xn[None, :]) ** 2
    assert np.all(np.abs(d2 - eps2) >= 1e-5 * scale)
    return eps2


@pytest.mark.parametrize(
    "nq, n, d, seed", [(403, 403, 7, 0), (150, 611, 3, 1), (97, 260, 33, 2)]
)
@pytest.mark.parametrize("q", [0.05, 0.3])
def test_count_matches_pallas_interpret_exactly(nq, n, d, seed, q):
    rng = np.random.default_rng(seed + 10)
    X = _points(n, d, seed)
    Q = X[:nq].copy() if nq == n else _points(nq, d, seed + 5)
    valid = rng.random(n) > 0.15  # holes
    eps2 = _eps2_away_from_every_pair(Q, X, q)
    want = np.asarray(jax_ps.fused_count_below(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(valid), eps2, interpret=True
    ))
    got = count.fused_count_below(
        torch.from_numpy(Q), torch.from_numpy(X), torch.from_numpy(valid), eps2
    )
    assert got.dtype == torch.int32 and got.shape == (nq,)
    np.testing.assert_array_equal(got.numpy(), want)
    expect = ((_d2_64(Q, X) <= eps2) & valid[None, :]).sum(1)
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("block", [1, 37, 1000])
def test_count_plain_blocking_changes_nothing(block):
    X = torch.from_numpy(_points(300, 5, 3))
    valid = torch.from_numpy(np.random.default_rng(3).random(300) > 0.2)
    whole = count.count_below_plain(X, X, valid, 4.0)
    np.testing.assert_array_equal(count.count_below_plain(X, X, valid, 4.0, block=block), whole)


def test_count_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    X = torch.from_numpy(_points(120, 4, 4))
    valid = torch.ones(120, dtype=torch.bool)
    before = count.fused_count_below.launches
    got = count.fused_count_below(X, X, valid, 3.0)
    assert torch.equal(got, count.count_below_plain(X, X, valid, 3.0))
    assert count.fused_count_below.launches == before
    assert int(got.min()) >= 1  # self is counted


@pytest.mark.parametrize(
    "Q, X, valid, exc",
    [
        (torch.zeros((4, 3), dtype=torch.float64), torch.zeros((5, 3)), torch.ones(5, dtype=torch.bool), TypeError),
        (torch.zeros((4, 3)), torch.zeros((5, 2)), torch.ones(5, dtype=torch.bool), ValueError),
        (torch.zeros((4, 3)), torch.zeros((5, 3)), torch.ones(5), TypeError),  # mask not bool
        (torch.zeros((4, 3)), torch.zeros((5, 3)), torch.ones(4, dtype=torch.bool), ValueError),
    ],
)
def test_count_wrapper_rejects_what_the_kernel_does_not_take(Q, X, valid, exc):
    with pytest.raises(exc):
        count.fused_count_below(Q, X, valid, 1.0)


@pytest.mark.parametrize("with_x2", [False, True])
def test_block_sq_dists_matches_the_jax_package(with_x2):
    Q, X = _points(50, 9, 6), _points(70, 9, 7)
    x2 = (X * X).sum(1) if with_x2 else None
    want = np.asarray(jax_knn._block_sq_dists(
        jnp.asarray(Q), jnp.asarray(X), None if x2 is None else jnp.asarray(x2)
    ))
    got = knn._block_sq_dists(
        torch.from_numpy(Q), torch.from_numpy(X), None if x2 is None else torch.from_numpy(x2)
    ).numpy()
    assert got.min() >= 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_query_blocks_cover_the_rows_once_within_the_byte_budget():
    blocks = list(knn.query_blocks(1000, 1 << 20))
    rows = np.concatenate([np.arange(1000)[b] for b in blocks])
    np.testing.assert_array_equal(rows, np.arange(1000))
    assert all(4 * (b.stop - b.start) * (1 << 20) <= knn.TILE_BYTES for b in blocks)


@pytest.mark.parametrize("nq", [1, 127, 128, 129, 1777, 262_144])
@pytest.mark.parametrize("n,d", [(1, 1), (127, 7), (128, 32), (5003, 33), (262_144, 32), (300, 257)])
def test_count_launch_plan_covers_every_query_once_and_fits(nq, n, d):
    """The kernel's launch (csrc/count.cu): one block a 128-query tile, every
    query in one block, every item in one 128-item tile, d in 32-column ring
    stages; the query tile's fragments stay in registers exactly when d <= 32
    (the main path's 262,144 x 32); the ring and the warps' counts fit the
    card's 227 KB."""
    g = count._plan(nq, n, d)
    Q, IT = count.QUERY_TILE, count.ITEM_TILE
    assert (g["blocks"] - 1) * Q < nq <= g["blocks"] * Q
    assert (g["item_tiles"] - 1) * IT < n <= g["item_tiles"] * IT
    assert (g["column_chunks"] - 1) * count.DEPTH < d <= g["column_chunks"] * count.DEPTH
    assert g["resident"] == (d <= count.DEPTH)
    assert g["smem"] <= count.MAX_SMEM_BYTES
    if (nq, n, d) == (262_144, 262_144, 32):
        assert g["blocks"] == 2048 and g["resident"] and g["column_chunks"] == 1


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), ties away from zero, as
    csrc/tf32x3.cuh's split rounds."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """x's TF32 part as the tensor cores read an f32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _count_3xtf32(Q, X, valid, eps2):
    """The count kernel's arithmetic in plain PyTorch: q.x in 3xTF32 per
    32-column ring stage (lo.hi + hi.lo, then hi.hi, in f32), the stages
    added in f32, d2 = fma(-2, q.x, q2) + x2m, clamped keeping NaN, an
    invalid item's x2m -1."""
    q2 = (Q * Q).sum(1)
    x2m = torch.where(valid, (X * X).sum(1), -1.0)
    cross = torch.zeros((Q.shape[0], X.shape[0]), dtype=torch.float32)
    for c in range(0, Q.shape[1], count.DEPTH):
        a, b = Q[:, c : c + count.DEPTH], X[:, c : c + count.DEPTH].T
        a_hi, b_hi = _tf32(a), _tf32(b)
        a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
        cross += (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
    d2 = (q2.double()[:, None] - 2.0 * cross.double()).float() + x2m[None, :]
    d2 = torch.where(d2 < 0, 0.0, d2)
    return ((x2m[None, :] >= 0) & (d2 <= eps2)).sum(1)


@pytest.mark.parametrize(
    "nq, n, d, seed", [(403, 403, 7, 0), (150, 611, 3, 1), (97, 260, 33, 2), (64, 300, 70, 3)]
)
@pytest.mark.parametrize("q", [0.05, 0.3])
def test_tf32x3_count_keeps_the_kernels_accuracy(nq, n, d, seed, q):
    """The tensor-core count's numerical design, emulated on the CPU: with
    eps² at least 1e-5 (|q| + |x|)² from every pair's d2, its counts equal
    the f64 count and the JAX package's Pallas count in interpret mode; at
    an eps² on a pair's d2 it differs from f64 only on pairs within
    chip_smoke.py's COUNT_RTOL band (4e-6 (|q| + |x|)²)."""
    rng = np.random.default_rng(seed + 20)
    X = _points(n, d, seed)
    Q = X[:nq].copy() if nq == n else _points(nq, d, seed + 5)
    valid = rng.random(n) > 0.15
    Qt, Xt, vt = torch.from_numpy(Q), torch.from_numpy(X), torch.from_numpy(valid)
    eps2 = _eps2_away_from_every_pair(Q, X, q)
    got = _count_3xtf32(Qt, Xt, vt, eps2).numpy()
    want = np.asarray(jax_ps.fused_count_below(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(valid), eps2, interpret=True
    ))
    np.testing.assert_array_equal(got, want)
    d2 = _d2_64(Q, X)
    eps2 = float(np.quantile(d2[:, valid], q))  # on a pair
    exact = ((d2 <= eps2) & valid[None, :]).sum(1)
    qn, xn = np.linalg.norm(Q.astype(np.float64), axis=1), np.linalg.norm(X.astype(np.float64), axis=1)
    near = ((np.abs(d2 - eps2) <= 4e-6 * (qn[:, None] + xn[None, :]) ** 2) & valid[None, :]).sum(1)
    got = _count_3xtf32(Qt, Xt, vt, eps2).numpy()
    assert np.all(np.abs(got - exact) <= near)


def test_count_nan_rows_count_nothing_in_the_tensor_core_form():
    """A NaN query counts nothing and a NaN item is counted by no query, in
    the kernel's 3xTF32 arithmetic (the split keeps a NaN a NaN) as in the
    plain version."""
    X = torch.from_numpy(_points(200, 5, 9))
    X[3, 1] = float("nan")
    X[10, 0] = float("nan")
    valid = torch.ones(200, dtype=torch.bool)
    valid[10] = False  # the caller's mask for a NaN row, and one it missed (row 3)
    got = _count_3xtf32(X, X, valid, 4.0)
    plain = count.count_below_plain(X, X, valid, 4.0)
    assert int(got[3]) == 0 and int(got[10]) == 0
    assert torch.equal(got.to(torch.int32), plain)


@pytest.mark.parametrize("eps2", [-1.0, -1e-30, float("nan")])
def test_a_negative_or_nan_eps2_counts_nothing(eps2):
    """max(d2, 0) <= eps2 holds for no pair when eps2 < 0 or NaN: the plain
    version counts nothing, and so does the kernel's form of the criterion
    (d2 <= eps2 for eps2 >= 0, nothing otherwise)."""
    X = torch.from_numpy(_points(150, 4, 12))
    valid = torch.ones(150, dtype=torch.bool)
    assert int(count.count_below_plain(X, X, valid, eps2).sum()) == 0
    got = _count_3xtf32(X, X, valid, eps2) if eps2 >= 0 else torch.zeros(150, dtype=torch.int64)
    assert int(got.sum()) == 0
