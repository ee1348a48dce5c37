#
# Level histograms of the random-forest builder (counterpart of the JAX
# package's ops/pallas_histogram.py):
#   node_bin_histogram(Xb, node_id, values, width, nbins) -> (width, d, nbins, s)
#     out[w, j, b, k] = sum_r [node_r = w] [Xb[r, j] = b] values[r, k],
#     with uint8 bins (the forest's, ops/trees.py::bin_features at maxBins <= 256)
#     or int32 ones;
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
# are in the source's header; `_plan` picks each launch's tile, warps, row
# stages and row ranges. The TPU's tile constants
# (BLOCK_ROWS, MAX_SEG_TILE, the node tile of 256, the VMEM budgets) have no
# counterpart here.
#

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda

HIST_WARPS = 16  # csrc/hist.cu HIST_WARPS_MAX: warps of a block
TILE_FEATURES = 32  # csrc/hist.cu HIST_LANES: a tile's features, one a lane
MIN_WARPS = 4  # bins are cut until this many warps share a tile
# a block's histogram replicas: small, so that three blocks share an SM. The
# forest's level nodes are very uneven and a warp that owns a large node bounds
# its block; more blocks an SM keep more such warps running. A level whose
# bins would have to be cut into tiles at that size (a node's bins do not fit
# MIN_WARPS replicas: many bins, many stats) takes WIDE_HIST_BYTES instead.
HIST_BYTES = 48 * 1024
WIDE_HIST_BYTES = 160 * 1024
SM_BYTES = 228 * 1024  # H100: shared memory of an SM (1 KB of it reserved a block)
MAX_SMEM_BYTES = 227 * 1024  # the most a block may use on the H100
MAX_STAGE_ROWS = 256
RING = 2  # csrc/hist.cu HIST_RING: row stages a block holds
SCAN_GROUPS = 4  # csrc/hist.cu HIST_SCAN: 32-row groups a warp lists at a time
HIST_WAVES = 4  # row ranges: about this many waves of the resident blocks
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


def _balanced(total: int, most: int) -> int:
    """The tile size that cuts `total` into as few tiles as `most` allows,
    all of about one size."""
    return -(-total // -(-total // max(1, most)))


def _budget(nbins: int, s: int) -> int:
    """Bytes of a block's replicas: HIST_BYTES, or WIDE_HIST_BYTES when a
    node's bins do not fit MIN_WARPS replicas in HIST_BYTES."""
    node = 4 * TILE_FEATURES * s * nbins
    return HIST_BYTES if MIN_WARPS * node <= HIST_BYTES else WIDE_HIST_BYTES


def _tiles(d: int, width: int, nbins: int, s: int) -> Tuple[int, int, int, int, int]:
    """(features, nodes, bins, P, R) of a block: a tile of up to
    TILE_FEATURES features, and as many bins and then nodes as fit with the
    warps' replicas in `_budget`, each (node, bin) cell taking s stats x 32
    lanes of f32 (csrc/hist.cu). P = min(HIST_WARPS, nodes) warps split the
    tile's nodes, and R of them split its rows, one replica of the tile each,
    as many as fit and HIST_WARPS allows: deep levels take P nodes' subsets of
    one replica, the root R replicas. Bins are cut until MIN_WARPS warps
    share a tile (a level of one node and many bins); node and bin tiles are
    balanced."""
    dt = min(d, TILE_FEATURES)
    cap = max(1, _budget(nbins, s) // (4 * TILE_FEATURES * s))  # cells that fit
    bt = min(nbins, cap)
    while True:
        wt = _balanced(width, max(1, cap // bt))
        P = min(HIST_WARPS, wt)
        R = max(1, min(HIST_WARPS // P, cap // (wt * bt)))
        if P * R >= MIN_WARPS or bt == 1:
            return dt, wt, _balanced(nbins, bt), P, R
        bt = -(-bt // 2)


def _vec16(d: int, dt: int, esize: int) -> bool:
    """Whether every tile of a row starts and ends on 16 bytes (the staging
    takes 16-byte copies; else the 4-byte words that cover the tile)."""
    return (d * esize) % 16 == 0 and (dt == d or (dt * esize) % 16 == 0)


def _slot_bytes(dt: int, esize: int, vec16: bool) -> int:
    """Bytes a staged row's bin ids take: the tile's, in 16-byte copies, or
    the 4-byte words that cover them wherever they start; a multiple of 16."""
    need = dt * esize if vec16 else 4 * -(-(dt * esize + 3) // 4)
    return -(-need // 16) * 16


def _hist_bytes(wt: int, bt: int, s: int, R: int) -> int:
    return 4 * R * wt * bt * s * TILE_FEATURES


def _list_bytes(P: int, R: int) -> int:
    """Each warp's list of its rows of a scan window (4-byte entries)."""
    return 4 * P * R * SCAN_GROUPS * 32


def _stage_rows(wt: int, bt: int, s: int, P: int, R: int, slot: int) -> int:
    """Rows a block stages at a time (a ring of RING stages): as many as fit
    beside the replicas and the warps' row lists within MAX_SMEM_BYTES, a
    multiple of 32, from 32 to MAX_STAGE_ROWS. A staged row is its bin ids,
    its node id, its s stats and its local node id (2 bytes, once)."""
    room = MAX_SMEM_BYTES - _hist_bytes(wt, bt, s, R) - _list_bytes(P, R)
    rows = room // (RING * (slot + 4 + 4 * s) + 2) // 32 * 32
    return max(32, min(MAX_STAGE_ROWS, rows))


def _smem_bytes(wt: int, bt: int, s: int, P: int, R: int, stage_rows: int, slot: int) -> int:
    """Dynamic shared memory of a block (csrc/hist.cu hist_smem_bytes)."""
    return (_hist_bytes(wt, bt, s, R) + RING * stage_rows * (slot + 4 + 4 * s)
            + 2 * stage_rows + _list_bytes(P, R))


def _chunks(n: int, tiles: int, out_elems: int, sms: int, per_sm: int = 4) -> Tuple[int, int]:
    """(rows per range, ranges): about per_sm blocks per SM over tiles x
    ranges, at least MIN_CHUNK_ROWS rows a range, and partials within
    PART_BYTES."""
    most = max(1, -(-n // MIN_CHUNK_ROWS))
    fit = max(1, PART_BYTES // max(4 * out_elems, 1))
    n_chunks = max(1, min(most, fit, -(-per_sm * sms // tiles)))
    rows = -(-max(n, 1) // n_chunks)
    return rows, -(-max(n, 1) // rows)


def _plan(n: int, d: int, width: int, nbins: int, s: int, esize: int, sms: int) -> dict:
    """The kernel's launch plan for one level (every argument of the C entry
    but the pointers)."""
    dt, wt, bt, P, R = _tiles(d, width, nbins, s)
    vec16 = _vec16(d, dt, esize)
    slot = _slot_bytes(dt, esize, vec16)
    stage_rows = _stage_rows(wt, bt, s, P, R, slot)
    smem = _smem_bytes(wt, bt, s, P, R, stage_rows, slot)
    tiles = -(-d // dt) * -(-width // wt) * -(-nbins // bt)
    out_elems = width * d * nbins * s
    resident = max(1, SM_BYTES // (smem + 1024))
    rows, n_chunks = _chunks(n, tiles, out_elems, sms, HIST_WAVES * resident)
    if n_chunks * tiles >= 2**31 or smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"the histogram kernel cannot take {width} nodes x {nbins} bins x {s} stats"
        )
    return dict(dt=dt, wt=wt, bt=bt, P=P, R=R, vec16=vec16, slot=slot, stage_rows=stage_rows,
                smem=smem, tiles=tiles, rows=rows, n_chunks=n_chunks,
                reduce_blocks=max(1, min(-(-out_elems // 256), 8 * sms)))


def _launch(entry: str, Xb, node_id, values, width: int, nbins: int) -> torch.Tensor:
    n, d = Xb.shape
    s = values.shape[1]
    if Xb.data_ptr() % 16:  # a view off a 16-byte boundary: the copies read aligned words
        Xb = Xb.clone()
    g = _plan(n, d, width, nbins, s, Xb.element_size(), _cuda.sm_count(Xb))
    out = torch.empty((width, d, nbins, s), dtype=torch.float32, device=Xb.device)
    part = (
        torch.empty((g["n_chunks"], width * d * nbins * s), dtype=torch.float32,
                    device=Xb.device)
        if g["n_chunks"] > 1 else out
    )
    tail = (g["rows"], g["n_chunks"], g["stage_rows"], g["slot"], int(g["vec16"]),
            g["reduce_blocks"], part.data_ptr(), out.data_ptr(), _cuda.stream_of(Xb))
    fn = _cuda.entry(entry)
    if node_id is None:
        rc = fn(Xb.data_ptr(), values.data_ptr(), n, d, s, nbins, g["dt"], g["bt"], g["R"], *tail)
    else:
        rc = fn(Xb.data_ptr(), Xb.element_size(), node_id.data_ptr(), values.data_ptr(), n, d,
                s, width, nbins, g["dt"], g["wt"], g["bt"], g["P"], g["R"], *tail)
    _cuda.check(rc, f"{entry} kernel")
    return out


BIN_TYPES = (torch.uint8, torch.int32)


def node_bin_histogram(
    Xb: torch.Tensor, node_id: torch.Tensor, values: torch.Tensor, width: int, nbins: int
) -> torch.Tensor:
    """(width, d, nbins, s) f32 level histogram of Xb (n, d) uint8 or int32
    bins under node_id (n,) int32 with values (n, s) f32."""
    n, d = Xb.shape
    s = values.shape[1]
    if Xb.dtype not in BIN_TYPES:
        raise TypeError(f"Xb must be uint8 or int32, got {Xb.dtype}")
    _cuda.require(Xb, "Xb", (n, d), Xb.dtype)
    _cuda.require(node_id, "node_id", (n,), torch.int32)
    _cuda.require(values, "values", (n, s))
    if width < 1 or nbins < 1:
        raise ValueError(f"width and nbins must be >= 1, got {width}, {nbins}")
    if n == 0:  # a rank with no rows adds zeros, without a launch
        return torch.zeros((width, d, nbins, s), dtype=torch.float32, device=Xb.device)
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
