#
# Level histograms of the random-forest builder (counterpart of the JAX
# package's ops/pallas_histogram.py):
#   node_bin_histogram(Xb, node_id, values, width, nbins) -> (width, d, nbins, s)
#     out[w, j, b, k] = sum_r [node_r = w] [Xb[r, j] = b] values[r, k];
#   segment_histogram(seg_ids, values, n_segments) -> (d, n_segments, s)
#     out[j, g, k] = sum_r [seg[r, j] = g] values[r, k].
# A node, bin or segment id outside its range matches nothing.
#
# Both launch the CUDA kernels of csrc/hist.cu for tensors on the card, and run
# `node_bin_histogram_plain` / `segment_histogram_plain` for tensors on the
# CPU. The plain versions are the JAX package's own non-Pallas route: per
# feature, one index_add_ at node * nbins + bin (a segment_sum), over row
# chunks of at most 2^28 (row, feature, stat) elements. The kernels add in a
# fixed order, so one input gives one histogram, bit for bit, on every run
# (and one forest, whatever its stats). Their design and bound on the H100
# are in the source's header; the TPU's tile constants
# (BLOCK_ROWS, MAX_SEG_TILE, the node tile of 256, the VMEM budgets) have no
# counterpart here.
#

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda

SMEM_BYTES = 64 * 1024  # a block's histogram tile
BLOCK_BYTES = 72 * 1024  # the tile and its two row stages: three blocks per SM
SM_BYTES = 228 * 1024  # H100: shared memory of an SM (1 KB of it reserved a block)
MAX_SMEM_BYTES = 227 * 1024  # the most a block may use on the H100
HIST_THREADS = 512  # csrc/hist.cu: at most 16 warps, one a feature of the tile
MAX_TILE_FEATURES = 128  # features of a tile, so a staged row stays small
CUT_TILE_FEATURES = 16  # a level cut into tiles: one warp a feature
MAX_STAGE_ROWS = 1024
PART_BYTES = 256 << 20  # scratch for the row ranges' partial histograms
MIN_CHUNK_ROWS = 1024
PLAIN_CHUNK_ELEMS = 1 << 28


def _segment_sums(seg_of, n: int, d: int, values: torch.Tensor, n_segments: int) -> torch.Tensor:
    """(d, n_segments, s): per feature j, the sum of values over rows with
    segment id g in column j of `seg_of(r0, r1)`, the (r1 - r0, d) ids of rows
    r0..r1; ids outside [0, n_segments) are dropped. Row-chunked so no chunk
    holds more than 2^28 (row, feature, stat) elements."""
    s = values.shape[1]
    out = torch.zeros((d, n_segments + 1, s), dtype=torch.float32, device=values.device)
    chunk = max(1, PLAIN_CHUNK_ELEMS // max(d * s, 1))
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        sg = seg_of(r0, r1)
        sg = torch.where((sg >= 0) & (sg < n_segments), sg, n_segments).T.contiguous()
        v = values[r0:r1]
        for j in range(d):
            out[j].index_add_(0, sg[j], v)
    return out[:, :n_segments]


def node_bin_histogram_plain(
    Xb: torch.Tensor, node_id: torch.Tensor, values: torch.Tensor, width: int, nbins: int
) -> torch.Tensor:
    """Plain PyTorch version of the node x bin kernel: the flattened segment
    id node * nbins + bin through `_segment_sums`, with rows whose node or bin
    is out of range dropped."""
    n, d = Xb.shape
    s = values.shape[1]

    def seg_of(r0: int, r1: int) -> torch.Tensor:
        xb, nd = Xb[r0:r1].long(), node_id[r0:r1, None].long()
        ok = (nd >= 0) & (nd < width) & (xb >= 0) & (xb < nbins)
        return torch.where(ok, nd * nbins + xb, -1)

    hist = _segment_sums(seg_of, n, d, values, width * nbins)
    return hist.reshape(d, width, nbins, s).permute(1, 0, 2, 3).contiguous()


def segment_histogram_plain(
    seg_ids: torch.Tensor, values: torch.Tensor, n_segments: int
) -> torch.Tensor:
    """Plain PyTorch version of the segment kernel."""
    n, d = seg_ids.shape
    return _segment_sums(
        lambda r0, r1: seg_ids[r0:r1].long(), n, d, values, n_segments
    ).contiguous()


def _tiles(d: int, width: int, nbins: int, s: int) -> Tuple[int, int, int]:
    """(features, nodes, bins) of a block's histogram tile: as many bins as
    fit (all of them unless nbins * s is very large), then nodes, then
    features, within SMEM_BYTES with each feature's region padded by one
    float, and at most MAX_TILE_FEATURES features. A level that has to be cut
    into feature tiles anyway is cut into tiles of at most CUT_TILE_FEATURES,
    one warp a feature: the histogram tile then leaves room for deep row
    stages, where a 56-feature tile at 4 nodes left room for 32 rows. Feature
    tiles of 8 or more are cut to a multiple of 8 (a 32-byte sector of a
    row's bin ids)."""
    cap = SMEM_BYTES // 4
    bt = max(1, min(nbins, (cap - 1) // s))
    wt = max(1, min(width, (cap - 1) // (bt * s)))
    dt = max(1, min(d, MAX_TILE_FEATURES, cap // (wt * bt * s + 1)))
    if dt < d:
        dt = min(dt, CUT_TILE_FEATURES)
    if 8 <= dt < d:
        dt -= dt % 8
    return dt, wt, bt


def _stage_rows(dt: int, wt: int, bt: int, s: int) -> int:
    """Rows a block stages at a time (two stages in flight): as many as keep
    the block within BLOCK_BYTES beside its histogram tile, a multiple of 32,
    from 32 to MAX_STAGE_ROWS. A staged row is its dt bin ids at an odd
    stride, its node id and its s stats."""
    room = BLOCK_BYTES - 4 * dt * (wt * bt * s + 1)
    rows = room // (8 * ((dt | 1) + 1 + s)) // 32 * 32
    return max(32, min(MAX_STAGE_ROWS, rows))


def _smem_bytes(dt: int, wt: int, bt: int, s: int, stage_rows: int) -> int:
    """Dynamic shared memory of a block (csrc/hist.cu hist_smem_bytes): the
    histogram tile and two stages of stage_rows rows."""
    return 4 * (dt * (wt * bt * s + 1) + 2 * stage_rows * ((dt | 1) + 1 + s))


def _chunks(n: int, tiles: int, out_elems: int, sms: int, per_sm: int = 4) -> Tuple[int, int]:
    """(rows per range, ranges): about per_sm blocks per SM over tiles x
    ranges, at least MIN_CHUNK_ROWS rows a range, and partials within
    PART_BYTES."""
    most = max(1, -(-n // MIN_CHUNK_ROWS))
    fit = max(1, PART_BYTES // max(4 * out_elems, 1))
    n_chunks = max(1, min(most, fit, -(-per_sm * sms // tiles)))
    rows = -(-max(n, 1) // n_chunks)
    return rows, -(-max(n, 1) // rows)


def _launch(entry: str, Xb, node_id, values, width: int, nbins: int) -> torch.Tensor:
    n, d = Xb.shape
    s = values.shape[1]
    dt, wt, bt = _tiles(d, width, nbins, s)
    tiles = -(-d // dt) * -(-width // wt) * -(-nbins // bt)
    out_elems = width * d * nbins * s
    stage_rows = _stage_rows(dt, wt, bt, s)
    smem = _smem_bytes(dt, wt, bt, s, stage_rows)
    # two waves of the blocks resident on an SM (by shared memory and threads)
    resident = max(1, min(SM_BYTES // (smem + 1024), 2048 // min(HIST_THREADS, 32 * dt)))
    rows, n_chunks = _chunks(n, tiles, out_elems, _cuda.sm_count(Xb), 2 * resident)
    if n_chunks * tiles >= 2**31 or smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"the histogram kernel cannot take {width} nodes x {nbins} bins x {s} stats"
        )
    out = torch.empty((width, d, nbins, s), dtype=torch.float32, device=Xb.device)
    part = (
        torch.empty((n_chunks, out_elems), dtype=torch.float32, device=Xb.device)
        if n_chunks > 1 else out
    )
    reduce_blocks = max(1, min(-(-out_elems // 256), 8 * _cuda.sm_count(Xb)))
    stream = _cuda.stream_of(Xb)
    fn = _cuda.entry(entry)
    if node_id is None:
        rc = fn(Xb.data_ptr(), values.data_ptr(), n, d, s, nbins, dt, bt, rows, n_chunks,
                stage_rows, reduce_blocks, part.data_ptr(), out.data_ptr(), stream)
    else:
        rc = fn(Xb.data_ptr(), node_id.data_ptr(), values.data_ptr(), n, d, s, width, nbins,
                dt, wt, bt, rows, n_chunks, stage_rows, reduce_blocks, part.data_ptr(),
                out.data_ptr(), stream)
    _cuda.check(rc, f"{entry} kernel")
    return out


def node_bin_histogram(
    Xb: torch.Tensor, node_id: torch.Tensor, values: torch.Tensor, width: int, nbins: int
) -> torch.Tensor:
    """(width, d, nbins, s) f32 level histogram of Xb (n, d) int32 bins under
    node_id (n,) int32 with values (n, s) f32."""
    n, d = Xb.shape
    s = values.shape[1]
    _cuda.require(Xb, "Xb", (n, d), torch.int32)
    _cuda.require(node_id, "node_id", (n,), torch.int32)
    _cuda.require(values, "values", (n, s))
    if width < 1 or nbins < 1:
        raise ValueError(f"width and nbins must be >= 1, got {width}, {nbins}")
    if _cuda.device_kind(Xb, node_id, values) == "cpu":
        return node_bin_histogram_plain(Xb, node_id, values, width, nbins)
    out = _launch("node_bin_hist", Xb, node_id, values, width, nbins)
    node_bin_histogram.launches += 1
    return out


def segment_histogram(
    seg_ids: torch.Tensor, values: torch.Tensor, n_segments: int
) -> torch.Tensor:
    """(d, n_segments, s) f32 histogram of seg_ids (n, d) int32 with values
    (n, s) f32."""
    n, d = seg_ids.shape
    s = values.shape[1]
    _cuda.require(seg_ids, "seg_ids", (n, d), torch.int32)
    _cuda.require(values, "values", (n, s))
    if n_segments < 1:
        raise ValueError(f"n_segments must be >= 1, got {n_segments}")
    if _cuda.device_kind(seg_ids, values) == "cpu":
        return segment_histogram_plain(seg_ids, values, n_segments)
    out = _launch("segment_hist", seg_ids, None, values, 1, n_segments)[0]
    segment_histogram.launches += 1
    return out


node_bin_histogram.launches = 0
segment_histogram.launches = 0
