"""PyTorch port, fused assignment kernel (spark_rapids_ml_torch/ops/select.py):
its plain version, which the CPU wrapper runs, against the JAX package's Pallas
kernel in interpret mode (ops/pallas_select.py::fused_assign) on the same numpy
inputs. The data have a clear margin, so the labels must be identical. The
n_split 2 form (parity_precision="high") against `_fused_assign(..., 2,
interpret=True)`, which splits explicitly, on blobs and on flip data, where the
split and f32 choose different centers for every row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_select import _fused_assign, fused_assign
from spark_rapids_ml_torch.ops import select


def _blobs(n, d, k, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 10, (k, d)).astype(np.float32)
    X = centers[rng.integers(0, k, n)] + rng.normal(0, 0.5, (n, d)).astype(np.float32)
    return X.astype(np.float32), centers


@pytest.mark.parametrize("n, d, k", [(1000, 3, 1), (777, 16, 20), (513, 130, 7)])
def test_assign_matches_fused_assign_interpret(n, d, k):
    X, C = _blobs(n, d, k, seed=d + k)
    got = select.assign(torch.from_numpy(X), torch.from_numpy(C))
    want = np.asarray(fused_assign(jnp.asarray(X), jnp.asarray(C), interpret=True))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_duplicate_centers_first_index_wins():
    X, C = _blobs(300, 8, 3, seed=5)
    C = np.concatenate([C, C[:2]])  # centers 3 and 4 duplicate 0 and 1
    got = select.assign(torch.from_numpy(X), torch.from_numpy(C)).numpy()
    want = np.asarray(fused_assign(jnp.asarray(X), jnp.asarray(C), interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got.max() <= 2  # the duplicates never win


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    X, C = _blobs(64, 4, 3)
    before = select.assign.launches
    got = select.assign(torch.from_numpy(X), torch.from_numpy(C))
    assert torch.equal(got, select.assign_plain(torch.from_numpy(X), torch.from_numpy(C)))
    assert select.assign.launches == before


def test_wrapper_rejects_mismatched_widths():
    with pytest.raises(ValueError):
        select.assign(torch.zeros((5, 3)), torch.zeros((2, 4)))


def _jax_assign_high(X, C, block=128):
    return np.asarray(_fused_assign(jnp.asarray(X), jnp.asarray(C), block, 2, True))


@pytest.mark.parametrize("n, d, k", [(1000, 3, 1), (777, 16, 20), (513, 130, 7)])
def test_high_assign_matches_the_jax_split_kernel(n, d, k):
    X, C = _blobs(n, d, k, seed=d + k)
    got = select.assign(torch.from_numpy(X), torch.from_numpy(C), 2)
    np.testing.assert_array_equal(got.numpy(), _jax_assign_high(X, C))


def test_high_assign_moves_every_flip_row_to_center_0():
    """Flip data (tests/test_torch_lloyd.py::_flip_data): the split puts every
    row at the origin, center 0; f32 each in its own center."""
    from tests.test_torch_lloyd import _flip_data

    X, C = _flip_data(901, 30, 5)
    got = select.assign(torch.from_numpy(X), torch.from_numpy(C), 2).numpy()
    np.testing.assert_array_equal(got, _jax_assign_high(X, C))
    assert (got == 0).all()
    assert (select.assign(torch.from_numpy(X), torch.from_numpy(C)).numpy() != 0).all()


def test_wrapper_rejects_a_split_it_has_no_form_for():
    with pytest.raises(ValueError, match="n_split"):
        select.assign(torch.zeros((5, 3)), torch.zeros((2, 3)), 1)


# ------------------------------------------- the nearest-center tile (csrc/nearest.cuh)
#
# The kernels compute the cross terms x.c in 3xTF32 on the tensor cores (f32
# form): each operand split into its TF32 part, rounded to nearest, and the
# rest, which the tensor cores read truncated to TF32; lo.hi + hi.lo + hi.hi
# chained over NT_CHAIN k-steps (32 columns) and the chains added in f32.
# `_cross_3xtf32` is that arithmetic in plain PyTorch. The labels it gives are
# held to f64 within the near-tie rule of chip_smoke.py (`near_ties`:
# TIE_RTOL = 1e-5 of |x|² + max |c|² between a row's two best centers), and to
# the JAX package's fused_assign in interpret mode on data with no near tie.

TIE_RTOL = 1e-5
CHAIN_COLS = 32  # NT_CHAIN k-steps of 8 columns


def _tf32(x):
    """x rounded to TF32, ties away from zero (csrc/tf32x3.cuh's split)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """x's TF32 part as the tensor cores read an f32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _cross_3xtf32(X, C):
    """(n, k) cross terms X C^T in the tile's 3xTF32 arithmetic."""
    cross = torch.zeros((X.shape[0], C.shape[0]), dtype=torch.float32)
    for c in range(0, X.shape[1], CHAIN_COLS):
        a, b = X[:, c : c + CHAIN_COLS], C[:, c : c + CHAIN_COLS].T
        a_hi, b_hi = _tf32(a), _tf32(b)
        a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
        cross += (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
    return cross


def _assign_3xtf32(X, C):
    Xt, Ct = torch.from_numpy(X), torch.from_numpy(C)
    x2 = (Xt * Xt).sum(1, keepdim=True)
    c2 = (Ct * Ct).sum(1)
    return torch.argmin(torch.clamp(x2 - 2.0 * _cross_3xtf32(Xt, Ct) + c2, min=0.0), dim=1).numpy()


def _criterion_64(X, C, full):
    X, C = X.astype(np.float64), C.astype(np.float64)
    crit = (C * C).sum(1)[None, :] - 2.0 * X @ C.T
    return crit + (X * X).sum(1)[:, None] if full else crit


def _near_ties(X, C, full):
    """Rows whose two best centers lie within TIE_RTOL (|x|² + max |c|²) of
    each other in f64 (chip_smoke.py::near_ties at the f32 form)."""
    crit = _criterion_64(X, C, full)
    if C.shape[0] < 2:
        return np.zeros(X.shape[0], bool)
    two = np.sort(crit, axis=1)[:, :2]
    scale = (X.astype(np.float64) ** 2).sum(1) + (C.astype(np.float64) ** 2).sum(1).max()
    return two[:, 1] - two[:, 0] <= TIE_RTOL * scale


def _near_blobs(n, d, k, seed, spread):
    """Rows around k centers drawn from the rows' own mixture, so that many
    rows lie near the boundary between two centers."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3, (8, d))
    X = centers[rng.integers(0, 8, n)] + rng.normal(0, spread, (n, d))
    C = X[rng.choice(n, k, replace=False)] + rng.normal(0, 0.05, (k, d))
    return X.astype(np.float32), C.astype(np.float32)


@pytest.mark.parametrize("n, d, k, seed", [(1500, 130, 20, 0), (1200, 256, 81, 1), (900, 7, 9, 2),
                                           (700, 33, 25, 3)])
def test_3xtf32_assign_agrees_with_f64_outside_near_ties(n, d, k, seed):
    X, C = _near_blobs(n, d, k, seed, spread=2.0)
    got = _assign_3xtf32(X, C)
    want = np.argmin(_criterion_64(X, C, True), axis=1)
    differ = got != want
    assert not np.any(differ & ~_near_ties(X, C, True))


@pytest.mark.parametrize("n, d, k, seed", [(700, 130, 20, 4), (600, 256, 81, 5), (513, 3, 1, 6)])
def test_3xtf32_assign_equals_fused_assign_without_near_ties(n, d, k, seed):
    X, C = _blobs(n, d, k, seed=seed)
    assert not _near_ties(X, C, True).any()
    want = np.asarray(fused_assign(jnp.asarray(X), jnp.asarray(C), interpret=True))
    np.testing.assert_array_equal(_assign_3xtf32(X, C), want)
    np.testing.assert_array_equal(select.assign(torch.from_numpy(X), torch.from_numpy(C)).numpy(),
                                  want)


# ------------------------------------------------------------ the launch plan

PLAN_K = (1, 8, 9, 20, 24, 25, 81, 257, 1000)
PLAN_D = (1, 3, 7, 130, 256, 257, 513, 1024)


def _plan_ns(R):
    return (1, R - 1, R, R + 1, 10_007, 8_388_608)


def _check_plan(g, n, k, d, n_split, lloyd):
    """A plan of ops/select.py::nearest_plan: every row in one block, each
    block's rows a whole number of R-row tiles and no block empty; the shared
    memory its layout's and at most 227 KB; the centers resident exactly where
    their parts fit beside the smallest ring (chunks of 24 centers where k
    pads to 24, else 88); rows whole exactly where a Lloyd step reads X once
    (an assignment also reads it once with one center chunk)."""
    R, rpb, blocks = g["R"], g["rows_per_block"], g["blocks"]
    assert R in select.ROW_TILES + (select.TALL[0],) and rpb % R == 0 and rpb >= R
    assert (blocks - 1) * rpb < max(n, 1) <= blocks * rpb
    assert blocks <= 132
    smem = select.nearest_smem(n_split, k, d, R, g["S"], g["DC"], g["resident"], g["CK"],
                               g["sums_smem"], lloyd)
    assert g["smem"] == smem <= select.MAX_SMEM_BYTES == 227 * 1024
    k_pad = -(-k // 8) * 8
    ck = 24 if k_pad <= 24 else 88
    d16 = -(-d // 16) * 16
    rings = [(R_, d16) for R_ in select.ROW_TILES] + [
        (64, dc) for dc in select.CHUNK_COLS if dc < d16]
    if not lloyd and ck >= k_pad:  # one chunk: an assignment's tall tiles
        rings += [(select.TALL[0], d16)] + [(select.TALL[0], dc) for dc in select.TALL[1]
                                            if dc < d16]
    fits = any(select.nearest_smem(n_split, k, d, R_, 2, DC, True, ck, False, lloyd)
               <= select.MAX_SMEM_BYTES for R_, DC in rings)
    assert g["resident"] == fits
    if g["resident"]:
        assert g["CK"] == ck
    assert g["whole"] == (g["DC"] == d16)
    n_cc = -(-k_pad // g["CK"])
    assert g["center_chunks"] == n_cc
    if lloyd:
        assert (g["x_reads"] == 1) == g["whole"]
    else:
        assert (g["x_reads"] == 1) == (g["whole"] or n_cc == 1)
    assert 2 <= g["S"] <= select.MAX_STAGES


@pytest.mark.parametrize("k", PLAN_K)
@pytest.mark.parametrize("d", PLAN_D)
def test_assign_plan_covers_every_row_once_and_fits(k, d):
    for n_split in (3, 2):
        R = select._plan(10_007, k, d, n_split)["R"]
        for n in _plan_ns(R):
            _check_plan(select._plan(n, k, d, n_split), n, k, d, n_split, False)


def test_assign_plan_at_the_main_shapes():
    """k = 20 at d = 256: 128-row tiles in two 128-column stages, the 24
    centers resident, X read once; k = 81: the 88 centers resident beside
    32-column stages in f32 (their TF32 parts fill 176 KB), 64-column stages
    at n_split 2; X read once."""
    n = 8_388_608
    for n_split in (3, 2):
        g = select._plan(n, 20, 256, n_split)
        assert (g["R"], g["DC"], g["CK"], g["resident"], g["x_reads"]) == (128, 128, 24, True, 1)
        assert g["blocks"] == 132
    g = select._plan(n, 81, 256, 3)
    assert (g["R"], g["DC"], g["CK"], g["resident"], g["x_reads"]) == (128, 32, 88, True, 1)
    g = select._plan(n, 81, 256, 2)
    assert (g["R"], g["DC"], g["CK"], g["resident"], g["x_reads"]) == (128, 64, 88, True, 1)
    g = select._plan(10_007, 257, 256, 3)  # phase 2a: centers in chunks, rows whole
    assert (g["resident"], g["whole"], g["x_reads"]) == (False, True, 1)
