"""PyTorch port, fused distance + smallest-k scan (spark_rapids_ml_torch/ops/topk.py):
the plain version, which the CPU wrapper runs, against the JAX package's Pallas
top-k kernel in interpret mode (ops/pallas_select.py::fused_topk) and its XLA
scan (ops/knn.py::exact_knn_single with strategy exact_full), on the same numpy
inputs.

Tolerance. The two packages' f32 matmuls block differently, so d2 may differ in
the last bits. With tol_i = 1e-5 * (q2_i + max valid x2), some 80 f32 ulps of
the terms d2 is computed from:
  * every returned d2 is within tol_i of the pair's f64 d2, in both packages,
    and so within 2 tol_i of each other;
  * ids are equal at every rank whose f64 neighbors (ranks r - 1 and r + 1) lie
    more than 2 tol_i away, and otherwise name items within 2 tol_i of that
    rank's f64 value;
  * exact ties (duplicate rows, the sentinel tail when k exceeds the valid
    items) are resolved lowest id first in both: their ids are equal, and the
    sentinel tail's values are INVALID_D2 bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import knn as jax_knn
from spark_rapids_ml_tpu.ops import pallas_select as jax_ps
from spark_rapids_ml_torch.ops import topk
from spark_rapids_ml_torch.ops.selection import INVALID_D2

SENTINEL = np.float32(INVALID_D2)


def _data(n, d, nq, seed, mask_frac):
    """Blobs, queries mostly rows of X (self-matches at d2 ~ 0) and a few fresh
    points, and rows 2 and 3 of X duplicated at n//2 and n//2 + 1 (valid)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3, (5, d))
    X = (centers[rng.integers(0, 5, n)] + rng.normal(0, 1, (n, d))).astype(np.float32)
    X[n // 2] = X[2]
    X[n // 2 + 1] = X[3]
    Q = np.concatenate([X[: nq - 3], rng.normal(0, 3, (3, d)).astype(np.float32)])
    valid = rng.random(n) > mask_frac
    valid[[2, 3, n // 2, n // 2 + 1]] = True
    return Q, X, valid


def _f64(Q, X, valid):
    """(nq, n) f64 d2, invalid items at the sentinel, and tol per query."""
    Q, X = Q.astype(np.float64), X.astype(np.float64)
    d2 = ((Q[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    d2 = np.where(valid[None, :], d2, float(SENTINEL))
    x2 = (X * X).sum(1)
    tol = 1e-5 * ((Q * Q).sum(1) + (x2[valid].max() if valid.any() else 0.0))
    return d2, tol


def _check(d2, ids, Q, X, valid, k, other=None, ref=None):
    """Hold (d2, ids) to f64 within tol, and to `other` (another package's
    result on the same inputs) as the module docstring says. `ref` is (f64 d2,
    tol) of a narrow form (_narrow_f64) in place of the exact one."""
    ref, tol = _f64(Q, X, valid) if ref is None else ref
    nq, n = ref.shape
    k = min(k, n)
    assert d2.shape == ids.shape == (nq, k)
    order = np.lexsort((np.broadcast_to(np.arange(n), ref.shape), ref), axis=1)
    ref_ids = order[:, : k + 1]
    ref_d2 = np.take_along_axis(ref, ref_ids, 1)
    got_d64 = np.take_along_axis(ref, ids.astype(np.int64), 1)
    assert np.all(np.diff(d2, axis=1) >= 0)  # ascending
    for i in range(nq):
        assert len(set(ids[i])) == k
        inval = ~valid[ids[i]]
        assert np.all(d2[i, inval].view(np.int32) == SENTINEL.view(np.int32))
        assert np.all(np.abs(d2[i, ~inval] - got_d64[i, ~inval]) <= tol[i])
        assert np.all(np.abs(got_d64[i] - ref_d2[i, :k]) <= 2 * tol[i])
        gap_lo = np.diff(ref_d2[i], prepend=-np.inf)[:k]
        gap_hi = np.diff(ref_d2[i])[:k] if k < n else np.append(np.diff(ref_d2[i])[: k - 1], np.inf)
        sure = (gap_lo > 2 * tol[i]) & (gap_hi > 2 * tol[i])
        np.testing.assert_array_equal(ids[i, sure], ref_ids[i, :k][sure])
        # the sentinel tail: the earliest invalid ids, in order
        n_tail = int(inval.sum())
        if n_tail:
            np.testing.assert_array_equal(ids[i, inval], np.nonzero(~valid)[0][:n_tail])
    if other is not None:
        o_d2, o_ids = other
        assert np.all(np.abs(d2 - o_d2) <= 2 * tol[:, None])
        for i in range(nq):
            same_d64 = np.abs(got_d64[i] - np.take_along_axis(ref[i], o_ids[i].astype(np.int64), 0))
            assert np.all((ids[i] == o_ids[i]) | (same_d64 <= 2 * tol[i]))


def _port(Q, X, valid, k, x2=None, fn=topk.fused_topk):
    t = lambda a: None if a is None else torch.from_numpy(a)
    d2, ids = fn(t(Q), t(X), t(valid), k, x2=t(x2))
    assert d2.dtype == torch.float32 and ids.dtype == torch.int32
    return d2.numpy(), ids.numpy()


@pytest.mark.parametrize(
    "n, d, nq, k, mask_frac",
    [(997, 13, 33, 10, 0.2), (1500, 32, 41, 33, 0.0), (603, 5, 17, 1, 0.5), (250, 29, 9, 64, 0.1)],
)
def test_fused_topk_matches_the_pallas_kernel_in_interpret_mode(n, d, nq, k, mask_frac):
    Q, X, valid = _data(n, d, nq, seed=n + k, mask_frac=mask_frac)
    want = jax_ps.fused_topk(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(valid), k, interpret=True)
    want = tuple(np.asarray(a) for a in want)
    got = _port(Q, X, valid, k)
    _check(*want, Q, X, valid, k)
    _check(*got, Q, X, valid, k, other=want)


@pytest.mark.parametrize("fn", ["fused_topk", "topk_plain"])
@pytest.mark.parametrize(
    "n, d, nq, k, mask_frac",
    [(2000, 32, 50, 10, 0.3), (777, 3, 64, 7, 0.0), (129, 17, 31, 100, 0.6)],
)
def test_topk_matches_the_xla_exact_full_scan(fn, n, d, nq, k, mask_frac):
    Q, X, valid = _data(n, d, nq, seed=d + k, mask_frac=mask_frac)
    want = jax_knn.exact_knn_single(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(valid), k, strategy="exact_full"
    )
    want = tuple(np.asarray(a) for a in want)
    got = _port(Q, X, valid, k, fn=getattr(topk, fn))
    _check(*got, Q, X, valid, k, other=want)


def test_duplicate_rows_tie_lowest_id_first_in_both_packages():
    Q, X, valid = _data(400, 8, 10, seed=5, mask_frac=0.0)
    want_d2, want_ids = (np.asarray(a) for a in jax_ps.fused_topk(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(valid), 4, interpret=True))
    d2, ids = _port(Q, X, valid, 4)
    for row, dup in ((2, 200), (3, 201)):  # query `row` is X[row] == X[dup]
        assert ids[row, 0] == row and ids[row, 1] == dup
        assert d2[row, 0].view(np.int32) == d2[row, 1].view(np.int32)  # one computation
        np.testing.assert_array_equal(ids[row, :2], want_ids[row, :2])


def test_k_above_the_valid_items_gives_the_earliest_invalid_ids_at_the_sentinel():
    Q, X, _ = _data(300, 6, 12, seed=6, mask_frac=0.0)
    valid = np.zeros(300, bool)
    valid[[17, 120, 250]] = True
    want = [np.asarray(a) for a in jax_knn.exact_knn_single(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(valid), 8, strategy="exact_full")]
    d2, ids = _port(Q, X, valid, 8)
    np.testing.assert_array_equal(np.sort(ids[:, :3], axis=1), np.tile([17, 120, 250], (12, 1)))
    np.testing.assert_array_equal(ids[:, 3:], np.tile([0, 1, 2, 3, 4], (12, 1)))
    assert np.all(d2[:, 3:].view(np.int32) == SENTINEL.view(np.int32))
    np.testing.assert_array_equal(ids[:, 3:], want[1][:, 3:])
    np.testing.assert_array_equal(d2[:, 3:].view(np.int32), want[0][:, 3:].view(np.int32))
    _check(d2, ids, Q, X, valid, 8, other=want)


def test_k_above_n_clamps_to_n():
    Q, X, valid = _data(40, 4, 6, seed=7, mask_frac=0.1)
    d2, ids = _port(Q, X, valid, 1000)
    assert d2.shape == (6, 40)
    np.testing.assert_array_equal(np.sort(ids, axis=1), np.tile(np.arange(40), (6, 1)))
    want = jax_ps.fused_topk(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(valid), 1000, interpret=True)
    _check(d2, ids, Q, X, valid, 1000, other=tuple(np.asarray(a) for a in want))


def test_cached_norms_route_gives_the_same_answer():
    Q, X, valid = _data(900, 11, 20, seed=8, mask_frac=0.2)
    x2 = (X * X).sum(1).astype(np.float32)
    want = jax_knn.exact_knn_single(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(valid), 6, x2=jnp.asarray(x2),
        strategy="exact_full",
    )
    cached = _port(Q, X, valid, 6, x2=x2)
    fresh = _port(Q, X, valid, 6)
    _check(*cached, Q, X, valid, 6, other=tuple(np.asarray(a) for a in want))
    np.testing.assert_array_equal(cached[1], fresh[1])


@pytest.mark.parametrize("block", [1, 7, 1000])
def test_topk_plain_blocking_changes_nothing_but_rounding(block):
    """A one-row block takes another matmul path, which rounds differently."""
    Q, X, valid = (torch.from_numpy(a) for a in _data(500, 9, 30, seed=9, mask_frac=0.2))
    d2, ids = topk.topk_plain(Q, X, valid, 5)
    d2b, idsb = topk.topk_plain(Q, X, valid, 5, block=block)
    assert torch.equal(ids, idsb)
    np.testing.assert_allclose(d2b.numpy(), d2.numpy(), rtol=1e-5, atol=1e-5 * float(d2.max()))


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    Q, X, valid = (torch.from_numpy(a) for a in _data(300, 4, 20, seed=10, mask_frac=0.1))
    before = topk.fused_topk.launches
    d2, ids = topk.fused_topk(Q, X, valid, 5)
    want = topk.topk_plain(Q, X, valid, 5)
    assert torch.equal(d2, want[0]) and torch.equal(ids, want[1])
    assert topk.fused_topk.launches == before


_T = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype)
_B = lambda n: torch.ones(n, dtype=torch.bool)


@pytest.mark.parametrize(
    "Q, X, valid, k, x2, exc",
    [
        (_T(4, 3, dtype=torch.float64), _T(5, 3), _B(5), 2, None, TypeError),
        (_T(4, 3), _T(5, 2), _B(5), 2, None, ValueError),
        (_T(4, 3), _T(5, 3), torch.ones(5), 2, None, TypeError),  # mask not bool
        (_T(4, 3), _T(5, 3), _B(4), 2, None, ValueError),
        (_T(4, 3), _T(3, 5).T, _B(5), 2, None, ValueError),  # X not contiguous
        (_T(4, 3), _T(5, 3), _B(5), 2, _T(4), ValueError),  # x2 of the wrong length
        (_T(4, 3), _T(5, 3), _B(5), 0, None, ValueError),
        (_T(4, 3), _T(300, 3), _B(300), topk.K_MAX + 1, None, ValueError),
        (_T(4, 3), _T(0, 3), _B(0), 1, None, ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(Q, X, valid, k, x2, exc):
    with pytest.raises(exc):
        topk.fused_topk(Q, X, valid, k, x2=x2)


@pytest.mark.parametrize(
    "nq, n, k, sms, pin, splits",
    [(4096, 8_388_608, 10, 132, None, 33), (100, 50_003, 200, 132, None, 12),
     (77, 5003, 10, 132, None, 1), (40_000, 10**6, 10, 132, None, 4),
     (1, 10**7, 1, 132, None, 132), (100, 8_388_608, 200, 132, None, 66),
     (100, 8_388_608, 200, 132, 1, 1), (100, 8_388_608, 200, 132, 7, 7),
     (4096, 8_388_608, 10, 132, 64, 64)],
)
def test_item_splits_cover_the_items_in_whole_chunks(nq, n, k, sms, pin, splits, monkeypatch):
    """The rule's split counts, and a pinned count (`_pin_splits`) in its place;
    the ranges cover the items in whole 128-item tiles."""
    monkeypatch.setattr(topk, "_pin_splits", pin)
    n_splits, per = topk._splits(nq, n, k, sms)
    assert n_splits == splits
    assert per % topk.ITEM_TILE == 0 and (n_splits - 1) * per < n <= n_splits * per
    assert n_splits == 1 or pin is not None or per >= topk.MIN_SPLIT_ITEMS


@pytest.mark.parametrize(
    "nq, n, k, sms",
    [(100, 8_388_608, 200, 132), (4096, 8_388_608, 10, 132), (1, 10**7, 1, 132),
     (65, 8_388_608, 256, 132), (1000, 8_388_608, 33, 132), (300, 2_000_000, 100, 114),
     (2048, 8_388_608, 10, 78)],
)
def test_item_ranges_fill_whole_waves(nq, n, k, sms):
    """Where the items allow it, query tiles x ranges is a whole number of
    waves of the card's resident blocks, at most MAX_WAVES of them."""
    n_splits, _ = topk._splits(nq, n, k, sms)
    tiles = -(-nq // topk.Q_TILE)
    assert n // n_splits >= topk.MIN_SPLIT_ITEMS
    assert (tiles * n_splits) % sms == 0  # one resident block per SM
    assert tiles * n_splits <= topk.MAX_WAVES * sms


@pytest.mark.parametrize("nq, n, k, sms", [(40_000, 8_388_608, 10, 132), (4000, 10**7, 256, 132)])
def test_item_ranges_past_the_wave_cap(nq, n, k, sms):
    """When whole waves would take more than MAX_WAVES, the rule takes just
    enough ranges for MAX_WAVES waves."""
    n_splits, _ = topk._splits(nq, n, k, sms)
    tiles = -(-nq // topk.Q_TILE)
    assert tiles * n_splits >= topk.MAX_WAVES * sms
    assert tiles * (n_splits - 1) < topk.MAX_WAVES * sms


@pytest.mark.parametrize("k, buffer_keys", [(1, 64), (10, 64), (33, 64), (200, 64), (226, 64),
                                            (227, 32), (topk.K_MAX, 32)])
def test_scan_shared_memory_fits_a_block(k, buffer_keys):
    """The scan's pools, buffers and ring fit one block's 227 KB at every k up
    to K_MAX: 64-key candidate buffers up to k = 226, 32-key ones above."""
    assert topk._buffer_keys(k) == buffer_keys
    assert topk._smem_bytes(k) <= topk.SMEM_BLOCK
    assert topk._smem_bytes(k) - topk._smem_bytes(1, buffer_keys) == 8 * topk.Q_TILE * (k - 1)


@pytest.mark.parametrize("pin", [0, topk.MAX_SPLITS + 1])
def test_a_pinned_split_count_out_of_range_raises(pin, monkeypatch):
    monkeypatch.setattr(topk, "_pin_splits", pin)
    with pytest.raises(ValueError, match="_pin_splits"):
        topk._splits(100, 8_388_608, 200, 132)


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


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, -(1.0 + 2.0**-11), 3.0e-3])
    r = _tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2.0**-10  # a tie rounds away from zero
    assert r[2] == 1.0 + 2.0**-9 and r[3] == -(1.0 + 2.0**-10)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all() and abs(float(r[4]) / 3.0e-3 - 1) < 2.0**-11


@pytest.mark.parametrize(
    "n, d, nq, k, mask_frac",
    [(997, 1, 33, 10, 0.2), (1500, 3, 65, 33, 0.0), (603, 33, 17, 1, 0.5), (250, 127, 9, 64, 0.1),
     (700, 256, 12, 200, 0.0)],
)
def test_tf32x3_distances_keep_the_kernels_accuracy(n, d, nq, k, mask_frac):
    """The top-k kernel's numerical design, emulated in plain PyTorch: d2 from
    3xTF32 cross terms, selected by the (d2, id) key, is within the kernel's
    tolerance of f64 (1e-5 (q2 + max x2)), with ids equal wherever f64
    neighbors are more than 2 tol apart, and agrees with the JAX package's
    Pallas kernel in interpret mode as the f32 version does."""
    from spark_rapids_ml_torch.ops.selection import mask_invalid, select_topk

    Q, X, valid = _data(n, d, nq, seed=3 * n + d, mask_frac=mask_frac)
    Qt, Xt = torch.from_numpy(Q), torch.from_numpy(X)
    q2, x2 = (Qt * Qt).sum(1), (Xt * Xt).sum(1)
    cross = _tf32x3_matmul(Qt, Xt.T)
    d2 = (q2[:, None] - 2.0 * cross + x2[None, :]).clamp(min=0.0)
    d2, ids = select_topk(mask_invalid(d2, torch.from_numpy(valid)[None, :]), k)
    want = jax_ps.fused_topk(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(valid), k, interpret=True)
    _check(d2.numpy(), ids.numpy(), Q, X, valid, k, other=tuple(np.asarray(a) for a in want))


def _hard_data(kind, n, d, nq, seed, tail):
    """The selection's hard inputs, as chip_smoke.py's phase 2a builds them:
    "descending", items at radii falling with their id around queries at (or
    within 1e-3 of) the origin, so each item is nearer than every one before
    it and every candidate passes the running k-th key; "duplicate", every
    item the same point, ties only. With `tail`, the last quarter invalid."""
    rng = np.random.default_rng(seed)
    if kind == "descending":
        u = rng.standard_normal((n, d))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        X = (np.linspace(20.0, 1.0, n)[:, None] * u).astype(np.float32)
        Q = (1e-3 * rng.standard_normal((nq, d))).astype(np.float32)
        Q[0] = 0.0
    else:
        X = np.repeat(rng.normal(0.0, 3.0, (1, d)), n, axis=0).astype(np.float32)
        Q = rng.normal(0.0, 3.0, (nq, d)).astype(np.float32)
    valid = np.ones(n, bool)
    if tail:
        valid[n - n // 4 :] = False
    return Q, X, valid


@pytest.mark.parametrize(
    "kind, n, d, nq, k, tail",
    [("descending", 700, 3, 5, 200, False), ("descending", 515, 33, 3, 64, True),
     ("duplicate", 300, 4, 7, 100, True), ("duplicate", 150, 1, 2, 200, False)],
)
def test_hard_selection_inputs_match_the_jax_package(kind, n, d, nq, k, tail):
    """Both sides of chip_smoke.py's hard top-k cases pinned on the CPU: the
    plain version against the JAX package's Pallas kernel in interpret mode;
    on all-duplicate items the ids are the valid ids in order, then the
    earliest invalid ones at the sentinel, in both packages."""
    Q, X, valid = _hard_data(kind, n, d, nq, seed=n + k, tail=tail)
    want = tuple(np.asarray(a) for a in jax_ps.fused_topk(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(valid), k, interpret=True))
    d2, ids = _port(Q, X, valid, k, fn=topk.topk_plain)
    _check(d2, ids, Q, X, valid, k, other=want)
    if kind == "descending":  # query 0 at the origin: the last valid items, nearest first
        last = np.nonzero(valid)[0][::-1][: min(k, int(valid.sum()))]
        np.testing.assert_array_equal(ids[0, : len(last)], last)
    else:
        order = np.concatenate([np.nonzero(valid)[0], np.nonzero(~valid)[0]])[: min(k, n)]
        np.testing.assert_array_equal(ids, np.tile(order, (nq, 1)))
        np.testing.assert_array_equal(want[1], np.tile(order, (nq, 1)))


# The narrow forms (bfloat16, int8) are held to the f64 value of their own
# distances, the cross term of the rounded or quantized operands in f64
# (_narrow_f64), with tol_i = RTOL_FORM * (q2_i + max valid x2):
#   * int8: 1e-5, the f32 form's: the int32 sums are exact in both packages,
#     and d2 differs from f64 only by the rescale, the epilogue and the norms'
#     summation order;
#   * bfloat16: 1e-5 + d * 2^-23: the f32 sums of the exact bf16 products are
#     taken in another order, at most d * 2^-24 * sum |q x| apart, twice that
#     in d2.
# Both packages' pools are held to that reference as the f32 form's results
# are held to f64 (_check), and so to each other.


def _narrow_f64(Q, X, valid, precision):
    """(nq, n) f64 d2 of a narrow form, invalid items at the sentinel, and tol."""
    Qt, Xt = torch.from_numpy(Q), torch.from_numpy(X)
    if precision == "bfloat16":
        cross = Qt.bfloat16().double() @ Xt.bfloat16().double().T
        rtol = 1e-5 + Q.shape[1] * 2.0**-23
    else:
        (qq, sq), (xq, sx) = topk.quantize_rows(Qt), topk.quantize_rows(Xt)
        cross = (qq.double() @ xq.double().T) * sq.double()[:, None] * sx.double()[None, :]
        rtol = 1e-5
    q2 = (Qt.double() ** 2).sum(1)
    x2 = (Xt.double() ** 2).sum(1)
    d2 = (q2[:, None] - 2.0 * cross + x2[None, :]).clamp(min=0.0).numpy()
    d2 = np.where(valid[None, :], d2, float(SENTINEL))
    x2max = float(x2[torch.from_numpy(valid)].max()) if valid.any() else 0.0
    return d2, rtol * (q2.numpy() + x2max)


@pytest.mark.parametrize("precision", ["bfloat16", "int8"])
@pytest.mark.parametrize(
    "n, d, nq, k, mask_frac",
    [(997, 13, 33, 10, 0.2), (1500, 32, 41, 33, 0.0), (603, 5, 17, 1, 0.5), (250, 29, 9, 64, 0.1)],
)
def test_narrow_forms_match_the_pallas_kernel_in_interpret_mode(precision, n, d, nq, k, mask_frac):
    """topk_plain in each narrow form against the JAX package's Pallas kernel
    in the same form, in interpret mode, at the oversampled pool width."""
    Q, X, valid = _data(n, d, nq, seed=n + k, mask_frac=mask_frac)
    kc = topk.oversample_width(k, n, precision)
    want = jax_ps.fused_topk(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(valid), kc,
                             precision=precision, interpret=True)
    want = tuple(np.asarray(a) for a in want)
    t = torch.from_numpy
    got = topk.topk_plain(t(Q), t(X), t(valid), kc, precision=precision)
    got = tuple(a.numpy() for a in got)
    ref = _narrow_f64(Q, X, valid, precision)
    _check(*want, Q, X, valid, kc, ref=ref)
    _check(*got, Q, X, valid, kc, other=want, ref=ref)


@pytest.mark.parametrize("precision", ["bfloat16", "int8"])
def test_narrow_cpu_wrapper_runs_the_plain_version_with_a_cached_item_operand(precision):
    """fused_topk on CPU tensors is topk_plain, with X's narrow operand made
    by the wrapper or passed in, and counts no launch of any form."""
    Q, X, valid = (torch.from_numpy(a) for a in _data(300, 21, 20, seed=11, mask_frac=0.1))
    items = topk.narrow_rows(X, precision)
    assert items.rows.shape == (300, 24 if precision == "bfloat16" else 32)
    assert not items.rows[:, 21:].any()  # zero padding to a whole 16 bytes
    before = [getattr(topk.fused_topk, c) for c in topk.LAUNCH_COUNTERS.values()]
    got = topk.fused_topk(Q, X, valid, 9, precision=precision)
    cached = topk.fused_topk(Q, X, valid, 9, precision=precision, items=items)
    want = topk.topk_plain(Q, X, valid, 9, precision=precision)
    for a in (got, cached):
        assert torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])
    assert [getattr(topk.fused_topk, c) for c in topk.LAUNCH_COUNTERS.values()] == before


def test_quantize_rows_is_the_tpu_kernels_quantization():
    """s = max |row| / 127 and round(row / max(s, 1e-30)), half to even; a
    zero row quantizes to zeros."""
    A = torch.tensor([[127.0, -63.5, 0.5, 1.5], [0.0, 0.0, 0.0, 0.0], [-2.54, 1.27, 0.0, 0.01]])
    q, s = topk.quantize_rows(A)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q[0].numpy(), [127, -64, 0, 2])  # -63.5 and 0.5: to even
    np.testing.assert_array_equal(q[1].numpy(), [0, 0, 0, 0])
    assert s[1] == 0.0 and int(q[2].abs().max()) == 127
    s_jax = jnp.max(jnp.abs(jnp.asarray(A.numpy())), axis=1, keepdims=True) / 127.0
    q_jax = jnp.round(jnp.asarray(A.numpy()) / jnp.maximum(s_jax, 1e-30)).astype(jnp.int8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_jax))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_jax)[:, 0])


@pytest.mark.parametrize(
    "k, n, precision, want",
    [(10, 1000, "float32", 10), (10, 1000, "bfloat16", 18), (100, 1000, "int8", 125),
     (100, 110, "int8", 110), (205, 10**6, "int8", 256), (206, 10**6, "bfloat16", 257)],
)
def test_oversample_width_is_the_jax_packages(k, n, precision, want):
    assert topk.oversample_width(k, n, precision) == want
    assert jax_ps.oversample_width(k, n, precision) == want


def test_unknown_form_raises():
    Q, X, valid = (torch.from_numpy(a) for a in _data(50, 4, 5, seed=12, mask_frac=0.0))
    with pytest.raises(ValueError, match="precision"):
        topk.fused_topk(Q, X, valid, 3, precision="float16")
    with pytest.raises(ValueError, match="narrow_rows"):
        topk.narrow_rows(X, "float32")
