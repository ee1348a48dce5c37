"""PyTorch port, fused Gram kernels (spark_rapids_ml_torch/ops/xtwx.py): their
plain versions, which the CPU wrappers run, against the JAX package's Pallas
kernels in interpret mode (ops/pallas_xtwx.py: xtx_pallas, xtxy_pallas,
covariance_prefix_mask, normal_eq_prefix_mask) on the same numpy inputs.

Tolerance: rtol 1e-5 and atol 1e-5·max|S2|, for f32 sums taken in a different
order by the two packages.

The n_split 2 form (parity_precision="high") against the kernels at HIGH, which
split explicitly in interpret mode: at the same tolerance on random data (the
port's column sums and Σy, Σy² come from the split products, Σ(x_hi + x_lo),
where the JAX kernel sums x in f32: 2^-17 of |x| a row apart); on split data,
where every sum is exact, S2 and Xᵀy within SPLIT_TOL = 2^-22 of their sum of
|products| per entry, and more than 10 SPLIT_TOL from the f32 form. PCA and
LinearRegression under "high" against the JAX estimators under "high" with
pallas_xtwx "1" (the kernels in interpret mode), at the estimators' own
tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_xtwx import (
    covariance_prefix_mask,
    normal_eq_prefix_mask,
    xtx_pallas,
    xtxy_pallas,
)
from spark_rapids_ml_torch import config as torch_config
from spark_rapids_ml_torch.ops import xtwx

HIGH = jax.lax.Precision.HIGH
SPLIT_TOL = 2.0**-22


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 2, (n, d)) + rng.normal(0, 0.5, (d,))).astype(np.float32)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("d", [1, 3, 130])
@pytest.mark.parametrize("n, n_valid", [(777, 777), (1000, 937)])
def test_xtx_matches_pallas_interpret(d, n, n_valid):
    X = _data(n, d, seed=d)
    s2_j, s1_j = xtx_pallas(
        jnp.asarray(X), n_valid, precision=jax.lax.Precision.HIGHEST, interpret=True
    )
    s2_t, s1_t = xtwx.xtx(torch.from_numpy(X), n_valid)
    _close(s2_t.numpy(), s2_j)
    _close(s1_t.numpy(), s1_j)


@pytest.mark.parametrize("d", [1, 3, 130])
def test_covariance_matches_covariance_prefix_mask(d):
    n, n_valid = 1203, 1100
    X = _data(n, d, seed=7 + d)
    w = np.ones((n,), np.float32)
    w[n_valid:] = 0.0  # suffix pad mask, the JAX package's pad_rows contract
    cov_j, mean_j, ws_j = covariance_prefix_mask(
        jnp.asarray(X), jnp.asarray(w), precision=jax.lax.Precision.HIGHEST, interpret=True
    )
    cov_t, mean_t, ws_t = xtwx.covariance_prefix_mask(torch.from_numpy(X), n_valid)
    _close(cov_t.numpy(), cov_j)
    _close(mean_t.numpy(), mean_j)
    assert float(ws_t) == float(ws_j) == n_valid


def test_rows_past_n_valid_never_reach_the_arithmetic():
    X = _data(100, 4)
    X[90:] = np.nan  # a select, not a multiply: NaN past n_valid must not leak
    s2, s1 = xtwx.xtx(torch.from_numpy(X), 90)
    assert np.isfinite(s2.numpy()).all() and np.isfinite(s1.numpy()).all()
    _close(s2.numpy(), X[:90].astype(np.float64).T @ X[:90].astype(np.float64))


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    X = torch.from_numpy(_data(50, 5))
    before = xtwx.xtx.launches
    s2, s1 = xtwx.xtx(X, 40)
    p2, p1 = xtwx.xtx_plain(X, 40)
    assert torch.equal(s2, p2) and torch.equal(s1, p1)
    assert xtwx.xtx.launches == before


@pytest.mark.parametrize(
    "X, n_valid, exc",
    [
        (torch.zeros((8, 3), dtype=torch.float64), 8, TypeError),
        (torch.zeros((3, 8)).T, 8, ValueError),  # not contiguous
        (torch.zeros((8, 3)), 9, ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(X, n_valid, exc):
    with pytest.raises(exc):
        xtwx.xtx(X, n_valid)


def _label(X, seed):
    rng = np.random.default_rng(seed)
    beta = rng.normal(0, 1, X.shape[1])
    return (X @ beta + 2.0 + rng.normal(0, 0.3, X.shape[0])).astype(np.float32)


@pytest.mark.parametrize("d", [1, 7, 130])
@pytest.mark.parametrize("n, n_valid", [(777, 777), (1000, 937)])
def test_xtxy_matches_pallas_interpret(d, n, n_valid):
    X = _data(n, d, seed=20 + d)
    y = _label(X, seed=d)
    want = xtxy_pallas(
        jnp.asarray(X), jnp.asarray(y), n_valid, precision=jax.lax.Precision.HIGHEST,
        interpret=True,
    )
    got = xtwx.xtxy(torch.from_numpy(X), torch.from_numpy(y), n_valid)
    assert len(got) == len(want) == 5  # S2, s1, Xᵀy, Σy, Σy²
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("d", [1, 7, 130])
def test_normal_eq_matches_normal_eq_prefix_mask(d):
    n, n_valid = 1203, 1100
    X = _data(n, d, seed=40 + d)
    y = _label(X, seed=41 + d)
    w = np.ones((n,), np.float32)
    w[n_valid:] = 0.0  # suffix pad mask, the JAX package's pad_rows contract
    want = normal_eq_prefix_mask(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
        precision=jax.lax.Precision.HIGHEST, interpret=True,
    )
    got = xtwx.normal_eq_prefix_mask(torch.from_numpy(X), torch.from_numpy(y), n_valid)
    assert len(got) == len(want) == 6  # A, b, x̄, ȳ, Σw, yᵀy
    for g, w_ in zip(got, want):
        _close(g.numpy(), w_)
    assert float(got[4]) == float(want[4]) == n_valid


def test_xtxy_rows_past_n_valid_never_reach_the_arithmetic():
    X = _data(100, 4)
    y = _label(X, seed=1)
    X[90:] = np.nan
    y[90:] = np.inf  # a select, not a multiply: inf * 0 would be NaN
    got = xtwx.xtxy(torch.from_numpy(X), torch.from_numpy(y), 90)
    assert all(np.isfinite(t.numpy()).all() for t in got)
    Xv, yv = X[:90].astype(np.float64), y[:90].astype(np.float64)
    _close(got[2].numpy(), Xv.T @ yv)
    np.testing.assert_allclose(float(got[3]), yv.sum(), rtol=1e-5)
    np.testing.assert_allclose(float(got[4]), yv @ yv, rtol=1e-5)


def test_xtxy_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    X = _data(50, 5)
    y = torch.from_numpy(_label(X, seed=2))
    X = torch.from_numpy(X)
    before = xtwx.xtxy.launches
    got = xtwx.xtxy(X, y, 40)
    want = xtwx.xtxy_plain(X, y, 40)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert xtwx.xtxy.launches == before


@pytest.mark.parametrize(
    "X, y, n_valid, exc",
    [
        (torch.zeros((8, 3)), torch.zeros(8, dtype=torch.float64), 8, TypeError),
        (torch.zeros((8, 3)), torch.zeros(7), 7, ValueError),  # y's length is not n
        (torch.zeros((8, 3)), torch.zeros((8, 2))[:, 0], 8, ValueError),  # not contiguous
        (torch.zeros((8, 3)), torch.zeros(8), -1, ValueError),
    ],
)
def test_xtxy_wrapper_rejects_what_the_kernel_does_not_take(X, y, n_valid, exc):
    with pytest.raises(exc):
        xtwx.xtxy(X, y, n_valid)


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 rounds: mantissa masking on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """x's TF32 part as the tensor cores read an f32 operand: the low 13 bits
    dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32x3_matmul(a, b):
    """a @ b as the kernels' 3xTF32 products take it (csrc/tf32x3.cuh): each
    operand split into hi, rounded to TF32, and lo = x - hi, of which the
    tensor cores read the TF32 part (the low 13 bits dropped); lo.hi + hi.lo
    summed first and hi.hi added last, every sum in f32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _rel_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("d", [1, 7, 129, 257])
@pytest.mark.parametrize("n, n_valid", [(5003, 5003), (5003, 4099)])
def test_tf32x3_gram_keeps_the_kernels_accuracy(d, n, n_valid):
    """The Gram kernel's numerical design, emulated in plain PyTorch: the
    statistics as entries of the Gram of Z = [X | y | 1], in 3xTF32, are within
    twice the f32 plain version's error against f64, plus 1e-6 (the bound
    chip_smoke.py holds the kernel to), and agree with the JAX package's Pallas
    kernel in interpret mode."""
    X = _data(n, d, seed=60 + d) + np.float32(1.5)  # offset columns: s1 matters
    y = _label(X, seed=61 + d)
    Z = np.concatenate([X, y[:, None], np.ones((n, 1), np.float32)], axis=1)
    Z[n_valid:] = 0.0  # the select the kernel's copies make
    Zt = torch.from_numpy(Z)
    G = _tf32x3_matmul(Zt.T.contiguous(), Zt).numpy()
    got = (G[:d, :d], G[:d, d + 1], G[:d, d], G[d, d + 1], G[d, d])  # S2, s1, Xᵀy, Σy, Σy²
    plain = [t.numpy() for t in xtwx.xtxy_plain(torch.from_numpy(X), torch.from_numpy(y), n_valid)]
    Xv, yv = X[:n_valid].astype(np.float64), y[:n_valid].astype(np.float64)
    ref = (Xv.T @ Xv, Xv.sum(0), Xv.T @ yv, yv.sum(), yv @ yv)
    for name, g, p, r in zip(("S2", "s1", "Xty", "sum y", "sum y^2"), got, plain, ref):
        e_g, e_p = _rel_err(g, r), _rel_err(p, r)
        assert e_g <= 2 * e_p + 1e-6, (name, e_g, e_p)
    want = xtxy_pallas(
        jnp.asarray(X), jnp.asarray(y), n_valid, precision=jax.lax.Precision.HIGHEST,
        interpret=True,
    )
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize(
    "n_valid, n_pairs, sms, chunks",
    [(8_388_608, 3, 132, 44), (8_388_608, 1, 132, 132), (8_388_608, 6, 132, 22),
     (8_388_608, 10, 132, 66), (9884, 3, 132, 9), (0, 3, 132, 1), (1, 1, 132, 1),
     (50_000_000, 3, 114, 38)],
)
def test_gram_chunks_fill_whole_waves(n_valid, n_pairs, sms, chunks):
    """The Gram kernel's launch plan: tiles x chunks a whole number of waves of
    one block per SM where the rows allow it, each chunk at least one inner
    flush of rows and a whole number of ring stages, the chunks covering the
    rows."""
    rows, n_chunks = xtwx._chunks(n_valid, n_pairs, sms)
    assert n_chunks == chunks
    assert rows % xtwx.ROWS_STEP == 0 and rows * (n_chunks - 1) < max(n_valid, 1) <= rows * n_chunks
    if n_valid >= n_chunks * xtwx.ROWS_PER_FLUSH * 2:
        assert (n_pairs * n_chunks) % sms == 0
    assert n_chunks == 1 or rows >= xtwx.ROWS_PER_FLUSH


def test_gram_shared_memory_fits_a_block():
    """The 4-stage ring of two 32 x 136 stripes and the outer sums fit one
    block's 227 KB on an H100."""
    assert xtwx.SMEM_BYTES <= 232_448


def _split_data(n, d, seed):
    """a (1 + 2^-9 + 2^-18), a uniform in 4..7: bf16 parts a and 2^-9 a and
    2^-18 a left over, so the split falls short of every product by 3·2^-18 of
    it; up to about 400 rows every sum of part products is exact."""
    rng = np.random.default_rng(seed)
    f = np.float32(1.0 + 2.0**-9 + 2.0**-18)
    X = rng.integers(4, 8, (n, d)).astype(np.float32) * f
    return X, rng.integers(4, 8, n).astype(np.float32) * f


@pytest.mark.parametrize("d", [1, 3, 130])
@pytest.mark.parametrize("n, n_valid", [(777, 777), (1000, 937)])
def test_high_xtx_and_xtxy_match_pallas_interpret_at_high(d, n, n_valid):
    X = _data(n, d, seed=d)
    y = (X @ np.linspace(-1, 1, d) + 0.5).astype(np.float32)
    want = xtxy_pallas(jnp.asarray(X), jnp.asarray(y), n_valid, precision=HIGH, interpret=True)
    got = xtwx.xtxy(torch.from_numpy(X), torch.from_numpy(y), n_valid, 2)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    s2_j, s1_j = xtx_pallas(jnp.asarray(X), n_valid, precision=HIGH, interpret=True)
    s2_t, s1_t = xtwx.xtx(torch.from_numpy(X), n_valid, 2)
    _close(s2_t.numpy(), s2_j)
    _close(s1_t.numpy(), s1_j)


@pytest.mark.parametrize("d", [2, 33])
def test_high_gram_is_the_split_not_f32(d):
    X, y = _split_data(401, d, seed=d)
    want = xtxy_pallas(jnp.asarray(X), jnp.asarray(y), 401, precision=HIGH, interpret=True)
    got = xtwx.xtxy(torch.from_numpy(X), torch.from_numpy(y), 401, 2)
    f32 = xtwx.xtxy(torch.from_numpy(X), torch.from_numpy(y), 401)
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    for i, mag in ((0, X64.T @ X64), (2, X64.T @ y64)):  # S2, Xᵀy
        g = got[i].double().numpy()
        assert np.max(np.abs(g - np.asarray(want[i], np.float64)) / mag) <= SPLIT_TOL
        assert np.min(np.abs(g - f32[i].double().numpy()) / mag) >= 10 * SPLIT_TOL


def test_gram_wrappers_reject_a_split_they_have_no_form_for():
    X = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="n_split"):
        xtwx.xtx(X, 5, 1)
    with pytest.raises(ValueError, match="n_split"):
        xtwx.xtxy(X, torch.zeros(5), 5, 1)


@pytest.fixture
def high_both():
    """parity_precision "high" in both packages; the JAX Gram kernels forced on
    (pallas_xtwx "1", its off-TPU escape hatch: interpret mode)."""
    from spark_rapids_ml_tpu import config as jax_config

    jax_config.set("parity_precision", "high")
    jax_config.set("pallas_xtwx", "1")
    torch_config.set("parity_precision", "high")
    yield
    jax_config.unset("parity_precision")
    jax_config.unset("pallas_xtwx")
    torch_config.unset("parity_precision")


def test_pca_under_high_matches_the_jax_estimator_under_high(high_both, monkeypatch):
    import spark_rapids_ml_tpu.feature as jax_feature
    from spark_rapids_ml_torch.feature import PCA
    from tests.test_torch_pca import _assert_same_model, _data as _pca_data

    seen = []
    real = xtwx.xtx
    monkeypatch.setattr(xtwx, "xtx", lambda X, nv, n_split=3: seen.append(n_split) or real(X, nv, n_split))
    X = _pca_data()
    want = jax_feature.PCA(k=3, inputCol="features").fit(X)
    got = PCA(k=3, inputCol="features", device="cpu").fit(X)
    assert seen == [2]
    _assert_same_model(got, want)


@pytest.mark.parametrize("params", [{}, {"regParam": 0.3, "elasticNetParam": 0.5}])
def test_linear_regression_under_high_matches_the_jax_estimator_under_high(
    params, high_both, monkeypatch
):
    from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinearRegression
    from spark_rapids_ml_torch.regression import LinearRegression
    from tests.test_torch_linear import _assert_same_model, _data as _lr_data, _frame

    seen = []
    real = xtwx.xtxy
    monkeypatch.setattr(xtwx, "xtxy", lambda X, y, nv, n_split=3: seen.append(n_split)
                        or real(X, y, nv, n_split))
    df = _frame(*_lr_data(seed=3))
    want = JaxLinearRegression(**params).fit(df)
    got = LinearRegression(device="cpu", **params).fit(df)
    assert seen == [2]
    _assert_same_model(got, want)
