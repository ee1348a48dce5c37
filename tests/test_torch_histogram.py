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


@pytest.mark.parametrize(
    "d,width,nbins,s",
    [(64, 1, 32, 2), (64, 32, 32, 2), (64, 32, 32, 3), (9, 300, 32, 1), (2, 256, 8, 5),
     (3, 1, 4, 2), (64, 1024, 256, 2), (5, 1, 100_000, 3), (1, 1, 2048, 5)],
)
def test_tiles_fit_the_shared_memory_budget_and_cover_the_histogram(d, width, nbins, s):
    dt, wt, bt = histogram._tiles(d, width, nbins, s)
    assert 1 <= dt <= min(d, histogram.HIST_THREADS) and 1 <= wt <= width and 1 <= bt <= nbins
    assert 4 * dt * (wt * bt * s + 1) <= histogram.SMEM_BYTES
    assert dt == d or dt < 8 or dt % 8 == 0
    if 4 * d * (width * nbins * s + 1) <= histogram.SMEM_BYTES:
        assert (dt, wt, bt) == (d, width, nbins)  # a level that fits is one tile


@pytest.mark.parametrize("n", [1, 1023, 1024, 50_000_000])
@pytest.mark.parametrize("tiles,out_elems", [(1, 2048), (8, 131_072), (40, 10**8)])
def test_row_ranges_cover_every_row_once(n, tiles, out_elems):
    rows, n_chunks = histogram._chunks(n, tiles, out_elems, 132)
    assert n_chunks >= 1 and rows * n_chunks >= n and rows * (n_chunks - 1) < n
    assert n_chunks == 1 or 4 * out_elems * n_chunks <= histogram.PART_BYTES


@pytest.mark.parametrize(
    "d,width,nbins,s",
    [(64, 1, 32, 2), (64, 32, 32, 3), (500, 1, 32, 2), (1000, 1, 2, 1), (9, 300, 32, 1),
     (5, 1, 100_000, 3), (64, 1024, 256, 2)],
)
def test_a_block_with_its_staged_rows_fits_the_card(d, width, nbins, s):
    """The kernel stages rows (bin ids, node id, stats) in two buffers beside
    the histogram tile (one warp a feature, in a fixed add order): a tile
    holds at most MAX_TILE_FEATURES features, a stage a multiple of 32 rows,
    and the block fits the card, within BLOCK_BYTES (three blocks a SM) where
    its tile leaves room for 32 rows."""
    dt, wt, bt = histogram._tiles(d, width, nbins, s)
    assert dt <= histogram.MAX_TILE_FEATURES
    assert dt == d or dt <= histogram.CUT_TILE_FEATURES  # a cut level: one warp a feature
    rows = histogram._stage_rows(dt, wt, bt, s)
    assert rows % 32 == 0 and 32 <= rows <= histogram.MAX_STAGE_ROWS
    smem = histogram._smem_bytes(dt, wt, bt, s, rows)
    assert smem == 4 * dt * (wt * bt * s + 1) + 8 * rows * ((dt | 1) + 1 + s)
    assert smem <= histogram.MAX_SMEM_BYTES
    if rows > 32:
        assert smem <= histogram.BLOCK_BYTES


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
