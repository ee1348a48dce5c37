"""PyTorch port, fused Lloyd step (spark_rapids_ml_torch/ops/lloyd.py): its plain
version, which the CPU wrapper runs, against the JAX package's Pallas kernels in
interpret mode at parity precision (ops/pallas_kmeans.py), and the port's
Lloyd loop against lloyd_fit_pallas, on the same numpy inputs; in its f32 form
(n_split 3, HIGHEST) and its bf16-split forms: n_split 2 against the kernels at
HIGH, and n_split 1, whose one bf16 pass the interpreter does not round
(it computes DEFAULT in f32 on the CPU), against a reference built here from
the JAX package's own `_split_bf16` and `_dot_multipass`.

Tolerances: counts equal; sums rtol 1e-5 with atol 1e-5·max|sums| and inertia
rtol 1e-5, for f32 sums taken in a different order; fitted centers within 1e-5.
`dot_multipass` against `_dot_multipass`: within SPLIT_TOL = 2^-22 of Σ|a||b|
per entry (the same exact part products summed in another order), and more
than 10 SPLIT_TOL from the f32 product somewhere (the split is computed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_kmeans import (
    _dot_multipass,
    _split_bf16,
    lloyd_fit_pallas,
    lloyd_step_pallas,
    lloyd_step_pallas_masked,
)
from spark_rapids_ml_torch.ops import lloyd
from spark_rapids_ml_torch.ops._precision import dot_multipass
from tests.test_torch_select import (
    _check_plan,
    _criterion_64,
    _cross_3xtf32,
    _near_blobs,
    _near_ties,
    _plan_ns,
)

HIGHEST = jax.lax.Precision.HIGHEST
HIGH = jax.lax.Precision.HIGH
PRECISION = {3: HIGHEST, 2: HIGH}
SPLIT_TOL = 2.0**-22
ROWS_DIMS = (((1,), (1,)), ((), ()))  # (n, d) x (k, d) -> (n, k)


def _blobs(n=600, d=8, k=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 6, (k, d)).astype(np.float32)
    X = centers[rng.integers(0, k, n)] + rng.normal(0, 1, (n, d)).astype(np.float32)
    init = X[rng.choice(n, k, replace=False)] + 0.5
    return X.astype(np.float32), init.astype(np.float32)


def _check_step(got, want):
    s_t, c_t, i_t = got
    s_j, c_j, i_j = (np.asarray(v, np.float64) for v in want)
    np.testing.assert_array_equal(c_t.numpy(), c_j)
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-5, atol=1e-5 * np.abs(s_j).max())
    assert float(i_t) == pytest.approx(float(i_j), rel=1e-5)


def _flip_data(n, d, p_count):
    """Rows and centers on which the bf16-split forms and f32 choose different
    centers (chip_smoke.py::flip_data): center 0 the origin, center 1 + p only
    column j_p at 2^e (2 + 2^-8); row i only column j_p, p = i mod P, at
    2^e (1 + 2^-9 + 2^-18). The split forms put every row in center 0, f32 in
    its center 1 + p."""
    cols = np.arange(p_count) * d // p_count
    scale = 2.0 ** np.array([-3.0, 0.0, 4.0])[np.arange(p_count) % 3]
    p = np.arange(n) % p_count
    X = np.zeros((n, d), np.float32)
    X[np.arange(n), cols[p]] = scale[p] * (1.0 + 2.0**-9 + 2.0**-18)
    C = np.zeros((p_count + 1, d), np.float32)
    C[1 + np.arange(p_count), cols] = scale * (2.0 + 2.0**-8)
    return X, C


@pytest.mark.parametrize("n, n_valid, d, k", [(600, 530, 8, 4), (777, 777, 3, 1), (513, 500, 130, 20)])
def test_unit_weight_step_matches_masked_pallas(n, n_valid, d, k):
    X, init = _blobs(n, d, k, seed=d)
    got = lloyd.lloyd_step(torch.from_numpy(X), torch.from_numpy(init), n_valid)
    want = lloyd_step_pallas_masked(
        jnp.asarray(X), n_valid, jnp.asarray(init), interpret=True, precision=HIGHEST
    )
    _check_step(got, want)


@pytest.mark.parametrize("n, d, k", [(600, 8, 4), (513, 130, 20)])
def test_weighted_step_matches_weighted_pallas(n, d, k):
    X, init = _blobs(n, d, k, seed=d + 1)
    rng = np.random.default_rng(3)
    w = rng.integers(0, 3, n).astype(np.float32)  # zeros included
    got = lloyd.lloyd_step(torch.from_numpy(X), torch.from_numpy(init), n, torch.from_numpy(w))
    want = lloyd_step_pallas(
        jnp.asarray(X), jnp.asarray(w), jnp.asarray(init), interpret=True, precision=HIGHEST
    )
    _check_step(got, want)


@pytest.mark.parametrize("n, n_valid, d, k", [(600, 530, 8, 4), (777, 777, 3, 1), (513, 500, 130, 20)])
def test_unit_weight_high_step_matches_masked_pallas_at_high(n, n_valid, d, k):
    X, init = _blobs(n, d, k, seed=d)
    got = lloyd.lloyd_step(torch.from_numpy(X), torch.from_numpy(init), n_valid, n_split=2)
    want = lloyd_step_pallas_masked(
        jnp.asarray(X), n_valid, jnp.asarray(init), interpret=True, precision=HIGH
    )
    _check_step(got, want)


@pytest.mark.parametrize("n, d, k", [(600, 8, 4), (513, 130, 20)])
def test_weighted_high_step_matches_weighted_pallas_at_high(n, d, k):
    X, init = _blobs(n, d, k, seed=d + 1)
    w = np.random.default_rng(3).integers(0, 3, n).astype(np.float32)
    got = lloyd.lloyd_step(torch.from_numpy(X), torch.from_numpy(init), n, torch.from_numpy(w), 2)
    want = lloyd_step_pallas(
        jnp.asarray(X), jnp.asarray(w), jnp.asarray(init), interpret=True, precision=HIGH
    )
    _check_step(got, want)


@pytest.mark.parametrize("n_split", [2, 1])
def test_dot_multipass_matches_the_jax_split(n_split):
    """The port's split product against the JAX package's: at n_split 2 its
    `_dot_multipass`; at 1 `_dot_multipass` of `_split_bf16(·, 1)`'s parts,
    the bf16-rounded operands the MXU multiplies."""
    rng = np.random.default_rng(n_split)
    a = rng.normal(0, 3, (1000, 64)).astype(np.float32)
    b = rng.normal(0, 3, (8, 64)).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    if n_split == 1:
        ja, jb = _split_bf16(ja, 1)[0], _split_bf16(jb, 1)[0]
    want = np.asarray(_dot_multipass(ja, jb, ROWS_DIMS, n_split), np.float64)
    got = dot_multipass(torch.from_numpy(a), torch.from_numpy(b).T, n_split).double().numpy()
    f32 = (torch.from_numpy(a) @ torch.from_numpy(b).T).double().numpy()
    mag = np.abs(a).astype(np.float64) @ np.abs(b).T.astype(np.float64)
    assert np.max(np.abs(got - want) / mag) <= SPLIT_TOL
    assert np.max(np.abs(want - f32) / mag) >= 10 * SPLIT_TOL


@pytest.mark.parametrize("weighted", [False, True])
def test_bf16_step_matches_a_reference_from_the_jax_split(weighted):
    """n_split 1: the kernel's formula (pallas_kmeans.py:211-228) on the
    products the MXU forms from bf16-rounded operands, built from the JAX
    package's _split_bf16 / _dot_multipass."""
    X, init = _blobs(513, 130, 20, seed=21)
    n_valid = 513 if weighted else 480
    w = np.random.default_rng(5).integers(0, 3, 513).astype(np.float32)
    if not weighted:
        w = (np.arange(513) < n_valid).astype(np.float32)
    Xm = jnp.where(jnp.arange(513)[:, None] < n_valid, jnp.asarray(X), 0.0)
    C = jnp.asarray(init)
    def bf(v):
        return _split_bf16(v, 1)[0]

    c2 = jnp.sum(C * C, axis=1)[None, :]
    part = c2 - 2.0 * _dot_multipass(bf(Xm), bf(C), ROWS_DIMS, 1)
    assign = jnp.argmin(part, axis=1)
    onehot = (jnp.arange(20)[None, :] == assign[:, None]).astype(jnp.float32) * jnp.asarray(w)[:, None]
    sums = _dot_multipass(bf(onehot), bf(Xm), (((0,), (0,)), ((), ())), 1)
    counts = jnp.sum(onehot, axis=0)
    x2 = jnp.sum(Xm * Xm, axis=1)
    inertia = jnp.sum(jnp.asarray(w) * jnp.maximum(x2 + jnp.min(part, axis=1), 0.0))
    got = lloyd.lloyd_step(
        torch.from_numpy(X), torch.from_numpy(init), n_valid,
        torch.from_numpy(w) if weighted else None, 1,
    )
    _check_step(got, (sums, counts, inertia))
    f32 = lloyd.lloyd_step(torch.from_numpy(X), torch.from_numpy(init), n_valid,
                           torch.from_numpy(w) if weighted else None)
    s_j = np.asarray(sums, np.float64)
    assert np.abs(f32[0].numpy() - s_j).max() >= 10 * 1e-5 * np.abs(s_j).max()


@pytest.mark.parametrize("n_split", [2, 1])
@pytest.mark.parametrize("weighted", [False, True])
def test_split_forms_move_every_flip_row_to_center_0(n_split, weighted):
    """On flip data the split forms put every row in center 0 (the JAX kernel
    at HIGH too), the f32 form none: the form is computed, not f32."""
    X, C = _flip_data(900, 40, 7)
    w = np.random.default_rng(7).integers(0, 4, 900).astype(np.float32) * (1 + 2.0**-9)
    wt = torch.from_numpy(w) if weighted else None
    s, c, _ = lloyd.lloyd_step(torch.from_numpy(X), torch.from_numpy(C), 900, wt, n_split)
    total = float(w.sum()) if weighted else 900.0
    assert float(c[0]) == pytest.approx(total, rel=1e-6)
    assert float(lloyd.lloyd_step(torch.from_numpy(X), torch.from_numpy(C), 900, wt)[1][0]) == 0.0
    if n_split == 2:
        want = (lloyd_step_pallas(jnp.asarray(X), jnp.asarray(w), jnp.asarray(C), interpret=True,
                                  precision=HIGH) if weighted else
                lloyd_step_pallas_masked(jnp.asarray(X), 900, jnp.asarray(C), interpret=True,
                                         precision=HIGH))
        _check_step((s, c, _), want)


def test_wrapper_rejects_an_unknown_split():
    X, init = _blobs(50, 3, 2)
    with pytest.raises(ValueError, match="n_split"):
        lloyd.lloyd_step(torch.from_numpy(X), torch.from_numpy(init), 50, n_split=4)


@pytest.mark.parametrize("unit_weight", [True, False])
def test_lloyd_fit_matches_lloyd_fit_pallas(unit_weight):
    _check_fit(unit_weight, 3)


@pytest.mark.parametrize("unit_weight", [True, False])
def test_high_lloyd_fit_matches_lloyd_fit_pallas_at_high(unit_weight):
    _check_fit(unit_weight, 2)


def _check_fit(unit_weight, n_split):
    X, init = _blobs(n=997, d=6, k=5, seed=11)
    w = np.ones((X.shape[0],), np.float32)
    if not unit_weight:
        w = np.random.default_rng(4).uniform(0.5, 2.0, X.shape[0]).astype(np.float32)
    c_j, in_j, it_j = lloyd_fit_pallas(
        jnp.asarray(X), jnp.asarray(w), jnp.asarray(init), 1e-6, 25,
        interpret=True, precision=PRECISION[n_split], unit_mask=unit_weight,
    )
    c_t, in_t, it_t = lloyd.lloyd_fit(
        torch.from_numpy(X), torch.from_numpy(w), torch.from_numpy(init), 1e-6, 25,
        unit_weight=unit_weight, n_split=n_split,
    )
    assert it_t == it_j
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)
    assert in_t == pytest.approx(in_j, rel=1e-5)


def test_weighted_form_requires_all_rows():
    X, init = _blobs(50, 3, 2)
    with pytest.raises(ValueError):
        lloyd.lloyd_step(torch.from_numpy(X), torch.from_numpy(init), 40, torch.ones(50))


def test_cpu_wrapper_counts_no_launch():
    X, init = _blobs(50, 3, 2)
    before = lloyd.lloyd_step.launches
    lloyd.lloyd_step(torch.from_numpy(X), torch.from_numpy(init), 50)
    assert lloyd.lloyd_step.launches == before


# ------------------------------------------- the nearest-center tile (csrc/nearest.cuh)
#
# The Lloyd kernel's f32 form on the tile: the cross terms in 3xTF32
# (tests/test_torch_select.py::_cross_3xtf32), the update in f32. Held to f64
# as chip_smoke.py's check_lloyd holds the kernel to plain: counts within the
# rows of the near ties (TIE_RTOL), sums within 1e-5 of max |sums| plus the
# rows that moved, inertia within 1e-5; and to the JAX kernels in interpret
# mode on data with no near tie (_check_step).


def _lloyd_3xtf32(X, C, n_valid, w=None):
    Xt, Ct = torch.from_numpy(X), torch.from_numpy(C)
    valid = torch.arange(X.shape[0]) < n_valid
    Xm = torch.where(valid[:, None], Xt, 0.0)
    wv = valid.float() if w is None else torch.where(valid, torch.from_numpy(w), 0.0)
    part = (Ct * Ct).sum(1)[None, :] - 2.0 * _cross_3xtf32(Xm, Ct)
    lab = torch.argmin(part, dim=1)
    onehot = torch.nn.functional.one_hot(lab, C.shape[0]).float() * wv[:, None]
    x2 = (Xm * Xm).sum(1)
    inertia = (wv * torch.clamp(x2 + part.gather(1, lab[:, None])[:, 0], min=0.0)).sum()
    return onehot.T @ Xm, onehot.sum(0), inertia


def _lloyd_64(X, C, n_valid, w=None):
    valid = np.arange(X.shape[0]) < n_valid
    wv = valid.astype(np.float64) if w is None else np.where(valid, w, 0.0)
    Xm = np.where(valid[:, None], X, 0).astype(np.float64)
    crit = _criterion_64(Xm, C, False)
    lab = np.argmin(crit, axis=1)
    onehot = np.eye(C.shape[0])[lab] * wv[:, None]
    x2 = (Xm * Xm).sum(1)
    inertia = (wv * np.maximum(x2 + crit[np.arange(len(lab)), lab], 0)).sum()
    return onehot.T @ Xm, onehot.sum(0), inertia, wv


@pytest.mark.parametrize("n, n_valid, d, k, seed", [(1500, 1441, 130, 20, 0), (1000, 1000, 256, 81, 1),
                                                    (777, 700, 7, 9, 2), (600, 600, 33, 25, 3)])
@pytest.mark.parametrize("weighted", [False, True])
def test_3xtf32_lloyd_step_agrees_with_f64_within_near_ties(n, n_valid, d, k, seed, weighted):
    X, C = _near_blobs(n, d, k, seed, spread=2.0)
    w = np.random.default_rng(seed).integers(0, 3, n).astype(np.float32) if weighted else None
    if weighted:
        n_valid = n
    s_e, c_e, i_e = _lloyd_3xtf32(X, C, n_valid, w)
    s_64, c_64, i_64, wv = _lloyd_64(X, C, n_valid, w)
    ties = _near_ties(np.where(wv[:, None] > 0, X, 0).astype(np.float32), C, False) & (wv > 0)
    count_diff = np.abs(c_e.double().numpy() - c_64).sum()
    assert count_diff <= 2.0 * wv.max() * ties.sum()
    tie_mass = (np.abs(X[ties]) * wv[ties, None]).sum(0).max() if ties.any() else 0.0
    tol = 1e-5 * np.abs(s_64).max() + (2.0 * tie_mass if count_diff else 0.0)
    assert np.abs(s_e.double().numpy() - s_64).max() <= tol
    assert float(i_e) == pytest.approx(i_64, rel=1e-5)


@pytest.mark.parametrize("n, n_valid, d, k", [(600, 530, 130, 20), (513, 500, 256, 81), (777, 777, 3, 1)])
@pytest.mark.parametrize("weighted", [False, True])
def test_3xtf32_lloyd_step_matches_the_pallas_kernels_without_near_ties(n, n_valid, d, k, weighted):
    X, init = _blobs(n, d, k, seed=d + k)
    w = np.random.default_rng(k).integers(0, 3, n).astype(np.float32) if weighted else None
    if weighted:
        n_valid = n
    valid = (np.arange(n) < n_valid)[:, None]
    assert not _near_ties(np.where(valid, X, 0).astype(np.float32), init, False).any()
    if weighted:
        want = lloyd_step_pallas(jnp.asarray(X), jnp.asarray(w), jnp.asarray(init), interpret=True,
                                 precision=HIGHEST)
    else:
        want = lloyd_step_pallas_masked(jnp.asarray(X), n_valid, jnp.asarray(init), interpret=True,
                                        precision=HIGHEST)
    _check_step(_lloyd_3xtf32(X, init, n_valid, w), want)


@pytest.mark.parametrize("k", (1, 8, 9, 20, 24, 25, 81, 257, 1000))
@pytest.mark.parametrize("d", (1, 3, 7, 130, 256, 257, 513, 1024))
def test_lloyd_plan_covers_every_row_once_and_fits(k, d):
    """ops/lloyd.py::_plan over the tile's edges (tests/test_torch_select.py::
    _check_plan): with whole rows in a stage the update reads them there and X
    is read once; the sums sit in registers exactly for one chunk of 24
    centers and whole rows of at most 256 columns, else in shared memory
    where k d fits beside the tile."""
    for n_split in (3, 1, 2):
        R = lloyd._plan(10_007, k, d, n_split)["R"]
        for n in _plan_ns(R):
            g = lloyd._plan(n, k, d, n_split)
            _check_plan(g, n, k, d, n_split, True)
            in_regs = g["CK"] == 24 and k <= 24 and g["whole"] and d <= 256
            assert (g["sums"] == "registers") == in_regs
            assert not (in_regs and g["sums_smem"])


def test_lloyd_plan_at_the_main_shape_and_past_the_whole_rows():
    """k = 20, d = 256: whole 64-row tiles, the sums in registers, X read
    once, in every form; d = 513 keeps whole rows (R = 16); at d = 1024 the
    f32 form takes the rows in column chunks, and the update reads them again
    (x_reads 2)."""
    for n_split in (3, 1, 2):
        g = lloyd._plan(8_388_608, 20, 256, n_split)
        assert (g["R"], g["whole"], g["sums"], g["x_reads"], g["blocks"]) == (
            64, True, "registers", 1, 132)
    g = lloyd._plan(10_007, 20, 513, 3)
    assert (g["R"], g["whole"], g["x_reads"]) == (16, True, 1)
    g = lloyd._plan(10_007, 20, 1024, 3)
    assert (g["whole"], g["x_reads"]) == (False, 2)
