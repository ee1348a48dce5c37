"""PyTorch port, level histograms of the forest builder
(spark_rapids_ml_torch/ops/histogram.py): the plain versions, which the CPU
wrappers run, against the JAX package's Pallas kernels in interpret mode
(ops/pallas_histogram.py: node_bin_histogram_pallas, segment_histogram_pallas)
on the same numpy inputs, at the cases of tests/test_pallas_histogram.py.

Tolerance: integer-valued stats (a classifier's counts) are exact, whatever the
order of the sums; normal values within rtol 1e-5, atol 1e-5 (a few f32 ulps of
sums of up to a thousand terms taken in another order)."""

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_histogram import (
    node_bin_histogram_pallas,
    segment_histogram_pallas,
)
from spark_rapids_ml_torch.ops import histogram

NODE_BIN_CASES = [
    (700, 4, 3, 8, 16),  # ragged rows, small level
    (1024, 2, 5, 256, 8),  # the TPU's full node tile
    (300, 9, 1, 300, 32),  # width > the TPU's node tile, odd d
    (50, 3, 2, 1, 4),  # root level
]
SEGMENT_CASES = [(700, 4, 3, 96), (1024, 2, 5, 2048), (50, 3, 1, 7)]


def _values(rng, n, s, integer):
    if integer:  # bootstrap-weighted class counts: small non-negative integers
        return rng.poisson(1.0, size=(n, s)).astype(np.float32)
    return rng.normal(size=(n, s)).astype(np.float32)


def _compare(got, want, integer):
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,d,s,width,nbins", NODE_BIN_CASES)
def test_node_bin_plain_matches_pallas_interpret(n, d, s, width, nbins, integer):
    rng = np.random.default_rng(3)
    Xb = rng.integers(0, nbins, size=(n, d)).astype(np.int32)
    node = rng.integers(0, width, size=(n,)).astype(np.int32)
    vals = _values(rng, n, s, integer)
    want = np.asarray(node_bin_histogram_pallas(Xb, node, vals, width, nbins, interpret=True))
    before = histogram.node_bin_histogram.launches
    got = histogram.node_bin_histogram(
        torch.from_numpy(Xb), torch.from_numpy(node), torch.from_numpy(vals), width, nbins
    )
    assert histogram.node_bin_histogram.launches == before  # CPU tensors: the plain version
    assert got.shape == (width, d, nbins, s) and got.dtype == torch.float32
    _compare(got.numpy(), want, integer)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,d,s,n_segments", SEGMENT_CASES)
def test_segment_plain_matches_pallas_interpret(n, d, s, n_segments, integer):
    rng = np.random.default_rng(0)
    seg = rng.integers(0, n_segments, size=(n, d)).astype(np.int32)
    vals = _values(rng, n, s, integer)
    want = np.asarray(segment_histogram_pallas(seg, vals, n_segments, interpret=True))
    got = histogram.segment_histogram(torch.from_numpy(seg), torch.from_numpy(vals), n_segments)
    assert got.shape == (d, n_segments, s)
    _compare(got.numpy(), want, integer)


def test_out_of_range_ids_and_zero_rows_add_nothing():
    Xb = torch.tensor([[0, 1], [1, 5], [1, 1], [0, 0], [1, -1]], dtype=torch.int32)
    node = torch.tensor([0, 1, -1, 2, 1], dtype=torch.int32)  # -1 and 2 match no node of 2
    vals = torch.tensor([[2.0], [3.0], [7.0], [11.0], [0.0]])
    got = histogram.node_bin_histogram(Xb, node, vals, 2, 2)
    want = torch.zeros((2, 2, 2, 1))
    want[0, 0, 0, 0] = 2.0  # row 0: node 0, bins (0, 1)
    want[0, 1, 1, 0] = 2.0
    want[1, 0, 1, 0] = 3.0  # row 1: node 1, bin 5 of feature 1 is out of range
    assert torch.equal(got, want)
    seg = torch.tensor([[0], [1], [1], [9]], dtype=torch.int32)
    got = histogram.segment_histogram(seg, torch.tensor([[2.0], [3.0], [0.0], [5.0]]), 4)
    assert torch.equal(got[0, :, 0], torch.tensor([2.0, 3.0, 0.0, 0.0]))


def test_plain_row_chunks_change_nothing(monkeypatch):
    rng = np.random.default_rng(5)
    n, d, s, width, nbins = 3001, 5, 2, 16, 8
    Xb = torch.from_numpy(rng.integers(0, nbins, size=(n, d)).astype(np.int32))
    node = torch.from_numpy(rng.integers(-1, width, size=(n,)).astype(np.int32))
    vals = torch.from_numpy(_values(rng, n, s, True))
    whole = histogram.node_bin_histogram_plain(Xb, node, vals, width, nbins)
    monkeypatch.setattr(histogram, "PLAIN_CHUNK_ELEMS", 7 * d * s)  # 7-row chunks
    assert torch.equal(histogram.node_bin_histogram_plain(Xb, node, vals, width, nbins), whole)


def test_wrappers_reject_what_the_kernel_does_not_take():
    Xb = torch.zeros((4, 2), dtype=torch.int32)
    node = torch.zeros((4,), dtype=torch.int32)
    vals = torch.ones((4, 2))
    with pytest.raises(TypeError):
        histogram.node_bin_histogram(Xb.long(), node, vals, 1, 2)
    with pytest.raises(ValueError):
        histogram.node_bin_histogram(Xb, node[:3], vals, 1, 2)
    with pytest.raises(ValueError):
        histogram.node_bin_histogram(Xb.T, node[:2], vals[:2], 1, 2)  # not contiguous
    with pytest.raises(TypeError):
        histogram.segment_histogram(Xb, vals.double(), 4)
    with pytest.raises(TypeError):
        histogram.segment_histogram(Xb.to(torch.uint8), vals, 4)  # segment ids are int32
    with pytest.raises(TypeError):
        histogram.node_bin_histogram(Xb.to(torch.int16), node, vals, 1, 2)


TILE_CASES = [
    (64, 1, 32, 2), (64, 32, 32, 2), (64, 32, 32, 3), (9, 300, 32, 1), (2, 256, 8, 5),
    (3, 1, 4, 2), (64, 1024, 256, 2), (5, 1, 100_000, 3), (1, 1, 2048, 5), (64, 16, 32, 3),
    (17, 7, 255, 2), (64, 64, 256, 3), (15, 2, 2, 5), (64, 1, 1024, 2), (500, 1, 32, 2),
]


@pytest.mark.parametrize("d,width,nbins,s", TILE_CASES)
def test_tiles_fit_the_shared_memory_budget_and_cover_the_histogram(d, width, nbins, s):
    """A block's tile: at most 32 features (one a lane), its node and bin
    tiles cover the level, 1-16 warps (P node subsets x R replicas, at least
    MIN_WARPS unless the bins are cut to one), the replicas within the
    budget: HIST_BYTES where a node's bins fit MIN_WARPS replicas there
    (the forest's 32 bins), else WIDE_HIST_BYTES; a level whose (node, bin)
    cells fit one replica set of MIN_WARPS warps is one tile."""
    dt, wt, bt, P, R = histogram._tiles(d, width, nbins, s)
    assert 1 <= dt <= min(d, histogram.TILE_FEATURES)
    assert dt == min(d, histogram.TILE_FEATURES)
    assert 1 <= wt <= width and 1 <= bt <= nbins
    assert 1 <= P <= wt and P * R <= histogram.HIST_WARPS
    assert P * R >= histogram.MIN_WARPS or bt == 1 or (wt == width and P == width)
    budget = histogram._budget(nbins, s)
    wide = histogram.MIN_WARPS * 4 * 32 * s * nbins > histogram.HIST_BYTES
    assert budget == (histogram.WIDE_HIST_BYTES if wide else histogram.HIST_BYTES)
    assert histogram._hist_bytes(wt, bt, s, R) <= budget
    # balanced node and bin tiles: the last is at most one smaller... than the rest
    for total, t in ((width, wt), (nbins, bt)):
        tiles = -(-total // t)
        assert (tiles - 1) * t < total <= tiles * t
        assert total - (tiles - 1) * t >= t - tiles + 1
    if 4 * 32 * width * nbins * s * max(1, histogram.MIN_WARPS // width) <= budget:
        assert (wt, bt) == (width, nbins)  # a level that fits is one tile


@pytest.mark.parametrize("n", [1, 1023, 1024, 50_000_000])
@pytest.mark.parametrize("tiles,out_elems", [(1, 2048), (8, 131_072), (40, 10**8)])
def test_row_ranges_cover_every_row_once(n, tiles, out_elems):
    rows, n_chunks = histogram._chunks(n, tiles, out_elems, 132)
    assert n_chunks >= 1 and rows * n_chunks >= n and rows * (n_chunks - 1) < n
    assert n_chunks == 1 or 4 * out_elems * n_chunks <= histogram.PART_BYTES


@pytest.mark.parametrize("d,width,nbins,s", TILE_CASES)
@pytest.mark.parametrize("esize", [1, 4])
def test_a_block_with_its_staged_rows_fits_the_card(d, width, nbins, s, esize):
    """The launch plan: a ring of RING stages, a stage a multiple of 32 rows from 32 to
    MAX_STAGE_ROWS, a staged row's bin slot a multiple of 16 bytes that holds
    the tile's bin ids (16-byte copies only where every row and tile starts
    on 16 bytes, else the covering 4-byte words, up to 3 bytes off), and the
    block's shared memory (csrc/hist.cu hist_smem_bytes) within the card's
    227 KB. The main path's uint8 rows of 64 features take 16-byte copies."""
    if esize == 1 and nbins > 256:
        return
    g = histogram._plan(50_000_000, d, width, nbins, s, esize, 132)
    rows, slot = g["stage_rows"], g["slot"]
    assert rows % 32 == 0 and 32 <= rows <= histogram.MAX_STAGE_ROWS
    assert slot % 16 == 0 and slot >= g["dt"] * esize + (0 if g["vec16"] else 3)
    if g["vec16"]:
        assert (d * esize) % 16 == 0 and (g["dt"] == d or (g["dt"] * esize) % 16 == 0)
    smem = (histogram._hist_bytes(g["wt"], g["bt"], s, g["R"])
            + histogram.RING * rows * (slot + 4 + 4 * s) + 2 * rows + 512 * g["P"] * g["R"])
    assert g["smem"] == smem <= histogram.MAX_SMEM_BYTES
    if (d, width, nbins, s, esize) == (64, 32, 32, 2, 1):
        assert g["vec16"] and slot == 32 and (g["wt"], g["P"], g["R"]) == (6, 6, 1)
    if (d, width, nbins, s, esize) == (64, 1, 32, 2, 1):
        assert (g["wt"], g["P"], g["R"]) == (1, 1, 6)
    if (d, nbins, esize) == (64, 32, 1):  # the forest's levels: three blocks an SM
        assert histogram.SM_BYTES // (smem + 1024) == 3


def _emulate(Xb, node, vals, width, nbins, plan):
    """The kernel of csrc/hist.cu in numpy f32, add for add in its order: per
    (row range, tile) block, per stage, the local node ids (-1: out of the
    tile or zero stats), each warp (rho, p) adding the rows of its
    contiguous share of the stage's 32-row groups and of the nodes, in row
    order, lane f on feature j0 + f, into
    replica rho; the replicas added in replica order; the row ranges'
    partials in row-range order. Returns the histogram and, per (row,
    feature), how many warps added it."""
    n, d = Xb.shape
    s = vals.shape[1]
    dt, wt, bt, P, R = (plan[k] for k in ("dt", "wt", "bt", "P", "R"))
    rows_per, n_chunks, stage_rows = plan["rows"], plan["n_chunks"], plan["stage_rows"]
    parts = np.zeros((n_chunks, width, d, nbins, s), np.float32)
    seen = np.zeros((n, d), np.int64)
    for c in range(n_chunks):
        r0, r1 = c * rows_per, min((c + 1) * rows_per, n)
        for tb in range(-(-nbins // bt)):
            for tw in range(-(-width // wt)):
                for td in range(-(-d // dt)):
                    j0, w0, b0 = td * dt, tw * wt, tb * bt
                    dn, wn, bn = min(dt, d - j0), min(wt, width - w0), min(bt, nbins - b0)
                    h = np.zeros((R, wn, bn, s, dn), np.float32)
                    for rs in range(r0, r1, stage_rows):
                        rows = min(stage_rows, r1 - rs)
                        wl = node[rs : rs + rows].astype(np.int64) - w0
                        ok = (wl >= 0) & (wl < wn) & (vals[rs : rs + rows] != 0).any(1)
                        wl = np.where(ok, wl, -1)
                        groups = -(-rows // 32)
                        per = -(-groups // R)
                        for warp in range(P * R):
                            rho, p = divmod(warp, P)
                            lo, hi = p * wn // P, (p + 1) * wn // P
                            for g in range(rho * per, min(groups, (rho + 1) * per)):
                                for rr in range(32 * g, min(32 * g + 32, rows)):
                                    if not lo <= wl[rr] < hi:
                                        continue
                                    r = rs + rr
                                    b = Xb[r, j0 : j0 + dn].astype(np.int64) - b0
                                    f = np.nonzero((b >= 0) & (b < bn))[0]
                                    seen[r, j0 + f] += 1
                                    for k in range(s):
                                        h[rho, wl[rr], b[f], k, f] += vals[r, k]
                    acc = np.zeros((wn, bn, s, dn), np.float32)
                    for rho in range(R):
                        acc += h[rho]
                    parts[c, w0 : w0 + wn, j0 : j0 + dn, b0 : b0 + bn] = acc.transpose(0, 3, 1, 2)
    out = np.zeros((width, d, nbins, s), np.float32)
    for c in range(n_chunks):
        out += parts[c]
    return out, seen


EMULATED = [  # (n, d, s, width, nbins, esize): ragged rows, tiles of every kind
    (700, 4, 3, 8, 16, 4), (1024, 2, 5, 256, 8, 4), (300, 9, 1, 300, 32, 1), (50, 3, 2, 1, 4, 1),
    (2500, 37, 2, 2, 32, 1), (1500, 17, 3, 32, 255, 1), (900, 5, 2, 1, 300, 4),
]


@pytest.mark.parametrize("n,d,s,width,nbins,esize", EMULATED)
def test_kernel_plan_adds_every_row_once_and_matches_plain(n, d, s, width, nbins, esize, monkeypatch):
    """The kernel's division of the work, emulated at small shapes with small
    stages and many row ranges: every (row, feature) whose node, bin and
    stats count is added by exactly one warp, none else is; integer stats
    give the plain histogram bit for bit, normal ones within 1e-5 of sum
    |val| per bin."""
    monkeypatch.setattr(histogram, "MIN_CHUNK_ROWS", 64)
    monkeypatch.setattr(histogram, "MAX_STAGE_ROWS", 64)
    rng = np.random.default_rng(n + d)
    dtype = np.uint8 if esize == 1 else np.int32
    Xb = rng.integers(0, nbins, size=(n, d)).astype(dtype)
    Xb[::7, 0] = min(nbins, 255)  # out of range (255 is in range at 256 bins)
    node = rng.integers(-1, width + 1, size=(n,)).astype(np.int32)
    plan = histogram._plan(n, d, width, nbins, s, esize, 64)
    assert plan["n_chunks"] > 1 or n < 128
    for integer in (True, False):
        vals = _values(rng, n, s, integer)
        vals[::3] = 0.0  # zero-stat rows, skipped
        vals[1::6] *= -0.0 if integer else 1.0
        got, seen = _emulate(Xb, node, vals, width, nbins, plan)
        want = histogram.node_bin_histogram_plain(
            torch.from_numpy(Xb), torch.from_numpy(node), torch.from_numpy(vals), width, nbins
        ).numpy()
        counted = ((node >= 0) & (node < width) & (vals != 0).any(1))[:, None] & (Xb.astype(np.int64) < nbins)
        np.testing.assert_array_equal(seen, counted.astype(np.int64))
        if integer:
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        else:
            absw = histogram.node_bin_histogram_plain(
                torch.from_numpy(Xb), torch.from_numpy(node), torch.from_numpy(np.abs(vals)),
                width, nbins).numpy()
            assert np.all(np.abs(got - want) <= 1e-5 * absw + 1e-30)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n,d,s,width,nbins", NODE_BIN_CASES + [(2000, 64, 3, 32, 32), (999, 15, 2, 4, 256)])
def test_uint8_bins_match_pallas_on_the_same_bins_as_int32(n, d, s, width, nbins, integer):
    """The forest's uint8 bins through the plain version (the CPU wrapper)
    against the JAX package's Pallas kernel in interpret mode on the same bins
    as int32: bit for bit on integer stats, within 1e-5 of sum |val| on normal
    ones."""
    rng = np.random.default_rng(11)
    Xb = rng.integers(0, nbins, size=(n, d)).astype(np.int32)
    node = rng.integers(0, width, size=(n,)).astype(np.int32)
    vals = _values(rng, n, s, integer)
    want = np.asarray(node_bin_histogram_pallas(Xb, node, vals, width, nbins, interpret=True))
    got = histogram.node_bin_histogram(
        torch.from_numpy(Xb.astype(np.uint8)), torch.from_numpy(node), torch.from_numpy(vals),
        width, nbins,
    ).numpy()
    if integer:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        absw = np.asarray(node_bin_histogram_pallas(Xb, node, np.abs(vals), width, nbins,
                                                    interpret=True))
        assert np.all(np.abs(got - want) <= 1e-5 * absw + 1e-30)


@pytest.mark.parametrize("s", [1, 2, 3])
def test_zero_stat_rows_change_no_bit(s):
    """The kernel skips rows whose stats are all zero (a bootstrap weight of
    0): on the plain version, the histogram with those rows equals the one
    with them dropped (node -1), bit for bit, on real-valued stats with -0
    among them (w y at w = 0 and y < 0)."""
    rng = np.random.default_rng(7 + s)
    n, d, width, nbins = 5000, 6, 8, 32
    Xb = torch.from_numpy(rng.integers(0, nbins, size=(n, d)).astype(np.uint8))
    node = torch.from_numpy(rng.integers(0, width, size=(n,)).astype(np.int32))
    w = rng.poisson(1.0, n).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    vals = torch.from_numpy(np.stack([w * y ** k for k in range(1, s + 1)], 1).astype(np.float32))
    zero = (vals == 0).all(1)
    assert bool((torch.signbit(vals) & (vals == 0)).any())  # -0 stats are there
    full = histogram.node_bin_histogram_plain(Xb, node, vals, width, nbins)
    dropped = histogram.node_bin_histogram_plain(Xb, torch.where(zero, -1, node), vals, width, nbins)
    assert torch.equal(full.view(torch.int32), dropped.view(torch.int32))


@pytest.mark.parametrize("n,d,s,width,nbins", NODE_BIN_CASES)
def test_real_valued_stats_give_one_histogram_every_run(n, d, s, width, nbins):
    """The plain version on real-valued stats: the same bits on every call
    (the kernel's fixed add order holds its own to this on the card, in
    chip_smoke.py's phase 2a)."""
    rng = np.random.default_rng(4)
    Xb = torch.from_numpy(rng.integers(0, nbins, size=(n, d)).astype(np.int32))
    node = torch.from_numpy(rng.integers(0, width, size=(n,)).astype(np.int32))
    vals = torch.from_numpy(rng.uniform(0, 2, size=(n, s)).astype(np.float32))
    runs = [histogram.node_bin_histogram(Xb, node, vals, width, nbins) for _ in range(3)]
    assert all(torch.equal(r.view(torch.int32), runs[0].view(torch.int32)) for r in runs)
