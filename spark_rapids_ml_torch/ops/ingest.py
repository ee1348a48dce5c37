#
# Host-to-device ingest of the PyTorch port (counterpart of the JAX package's
# ops/ingest.py): the one place where host rows are staged and uploaded, for
# the streamed fits (ops/streaming.py) and for in-core staging
# (core/estimator.py::stage). Under a process group each rank stages only its
# own rows, which its caller passes it.
#
#   * `stage_block` hands a CONTIGUOUS slice whose dtype the device casts
#     exactly (`_device_castable`) to the upload as it is, a view: no host copy
#     and no host conversion. The cast to the compute dtype runs on the device
#     after the upload (`upload`: small ints, bool and f16 are widened there).
#     Anything else takes a COUNTED host copy, into a `StagingPool` buffer.
#   * On the card every upload goes through a `PinnedRing`: two or more
#     page-locked host buffers. The host copies a chunk of the source into a
#     free buffer (`Tensor.copy_`, which runs on all of PyTorch's CPU threads),
#     and the buffer goes up with `non_blocking=True` on a side CUDA stream, so
#     the host copy of chunk i+1 overlaps the DMA of chunk i. Pinning that fails
#     raises: the ring never gives way to a pageable copy.
#
# Aliasing. On the CPU `torch.from_numpy` SHARES the host buffer, as CPU
# device_put does in the JAX package. A reused staging buffer would then
# overwrite a batch that the device cache (ops/device_cache.py) still holds, so
# on the CPU the pool allocates a fresh buffer per block. Uploads to the card
# copy, and there the pool reuses a ring of two buffers.
#
# Stream order on the card. The pinned buffer of a chunk is refilled only after
# the event of its last copy has completed. The device tensor an upload lands
# in is allocated on the compute (current) stream, and the side stream waits
# for the compute stream's work queued so far before it writes there, so memory
# the allocator hands back after a kernel read it is refilled only once that
# kernel has finished; the compute stream waits on the copy's event before
# anything reads the tensor. (Tensors allocated on the side stream would stay in
# its own pool of the caching allocator, out of the compute stream's reach.)
# One side stream serves each device.
#
# Counters (`counters`, zeroed by `reset_counters`) replace the JAX package's
# observability registry: bytes_zero_copy and bytes_copied (host staging),
# host_convert_s (the counted copies' seconds), and h2d_bytes / h2d_s (bytes
# uploaded to the card, and the host's wall seconds in those uploads).
#

from __future__ import annotations

import time
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import config as _config

# The pinned ring's chunk and depth on the card, from chip_smoke.py's H2D sweep
# (phase 3s, 8.6 GB copies, NVIDIA H100 80GB HBM3 at 700 W, two hosts; PERF.md
# section 5): 4 MiB chunks 12-20 GB/s, 16-256 MiB 17-35 GB/s at depths 2-8
# with no setting ahead on both hosts, this ring 22-35 GB/s, against 6.8-7.3
# GB/s for a pageable copy_; its host copy bounds it (the DMA from page-locked
# memory ran at 45-55 GB/s).
# The counted-copy pool's rows when the width is unknown: the JAX package's
# default (autotune/defaults.py INGEST_STAGING_POOL_ROWS).
RING_CHUNK_BYTES = 16 << 20
RING_DEPTH = 4
DEFAULT_POOL_ROWS = 1 << 16

counters: Dict[str, float] = {}


def reset_counters() -> None:
    counters.update(bytes_zero_copy=0, bytes_copied=0, host_convert_s=0.0,
                    h2d_bytes=0, h2d_s=0.0)


reset_counters()


def count_conversion(nbytes: int, seconds: float) -> None:
    """Count a host conversion copy made outside stage_block (the Arrow and
    pandas extraction fallbacks of core/dataset.py, the in-core host cast)."""
    counters["bytes_copied"] += int(nbytes)
    counters["host_convert_s"] += float(seconds)


def resolve_staging_pool_rows(d: Optional[int] = None, itemsize: int = 4) -> int:
    """Rows per staging buffer: a non-zero `ingest.staging_pool_rows` wins, else
    the rows of one RING_CHUNK_BYTES chunk at width d, else DEFAULT_POOL_ROWS."""
    pinned = int(_config.get("ingest.staging_pool_rows") or 0)
    if pinned > 0:
        return pinned
    if d:
        return max(1, RING_CHUNK_BYTES // (int(d) * int(itemsize)))
    return DEFAULT_POOL_ROWS


class StagingPool:
    """Host buffers of the counted copy: per (slot, dtype, trailing shape), a
    ring of two buffers of `resolve_staging_pool_rows()` rows (growing to the
    largest block seen), alternated per call, where the upload copies (the
    card). Where it aliases (the CPU) every call allocates a fresh buffer."""

    _RING = 2

    def __init__(self, device: torch.device, pool_rows: Optional[int] = None) -> None:
        self.reuse = device.type != "cpu"
        self._pool_rows = pool_rows
        self._bufs: Dict[Tuple, list] = {}
        self._turn: Dict[Tuple, int] = {}

    def buffer(self, shape: Tuple[int, ...], dtype: Any, slot: Any = None) -> np.ndarray:
        rows = int(shape[0])
        tail = tuple(int(x) for x in shape[1:])
        if not self.reuse:
            return np.empty((rows,) + tail, dtype)
        if self._pool_rows is None:
            self._pool_rows = resolve_staging_pool_rows()
        key = (slot, np.dtype(dtype), tail)
        ring = self._bufs.setdefault(key, [None] * self._RING)
        turn = self._turn.get(key, 0)
        self._turn[key] = (turn + 1) % self._RING
        buf = ring[turn]
        if buf is None or buf.shape[0] < rows:
            buf = np.empty((max(rows, self._pool_rows),) + tail, dtype)
            ring[turn] = buf
        return buf[:rows]


def _device_castable(src: np.dtype, dst: np.dtype) -> bool:
    """Dtypes whose cast on the device gives the bits of the host `astype` it
    replaces: the identity, exact float widenings, bool, and ints of at most
    32 bits (numpy and PyTorch both round to nearest even). int64 is left to
    the host, as in the JAX package."""
    src, dst = np.dtype(src), np.dtype(dst)
    if src == dst:
        return True
    if src == np.bool_:
        return True
    if src.kind in ("i", "u") and src.itemsize <= 4:
        return True
    if src.kind == "f" and dst.kind == "f" and src.itemsize < dst.itemsize:
        return True  # exact widening (f16->f32, f32->f64)
    return False


def stage_block(arr: np.ndarray, s: int, e: int, dtype: Any,
                pool: Optional[StagingPool] = None, *, slot: Any = None,
                force_copy: bool = False) -> np.ndarray:
    """Rows [s, e) of a host array, ready to upload: the slice itself when it is
    contiguous and `_device_castable` to `dtype` (the upload casts on the
    device), else a counted copy in `dtype`, into a pool buffer when a pool is
    given. `force_copy` asks for a copy the caller owns."""
    blk = np.asarray(arr[s:e])
    dt = np.dtype(dtype)
    if (
        not force_copy
        and bool(_config.get("ingest.zero_copy"))
        and blk.flags.c_contiguous
        and _device_castable(blk.dtype, dt)
    ):
        counters["bytes_zero_copy"] += blk.nbytes
        return blk
    t0 = time.perf_counter()
    if pool is not None:
        out = pool.buffer(blk.shape, dt, slot)
        np.copyto(out, blk, casting="unsafe")
    else:
        out = np.ascontiguousarray(blk, dtype=dt)
        if out is blk:  # a conforming block: this branch promises owned memory
            out = blk.copy()
    count_conversion(out.nbytes, time.perf_counter() - t0)
    return out


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor sharing the memory of the contiguous array `a`. Read-only
    arrays (as JAX and Arrow hand them over) are shared too: nothing in this
    package writes to an input."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(a)


_side_streams: Dict[int, Any] = {}


def _side_stream(device: torch.device):
    """The side CUDA stream of uploads to `device`, one per device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _side_streams:
        _side_streams[index] = torch.cuda.Stream(index)
    return _side_streams[index]


class PinnedRing:
    """`depth` page-locked host buffers of `chunk_bytes` each and a side CUDA
    stream, through which host arrays go up to the card (module header)."""

    def __init__(self, device: torch.device, chunk_bytes: int = RING_CHUNK_BYTES,
                 depth: int = RING_DEPTH) -> None:
        if depth < 2:
            raise ValueError(f"a pinned ring needs two or more buffers, got {depth}")
        self.chunk_bytes = int(chunk_bytes)
        # pinning that fails raises here (a RuntimeError from the CUDA host allocator)
        self.bufs = [torch.empty(self.chunk_bytes, dtype=torch.uint8, pin_memory=True)
                     for _ in range(depth)]
        self.events: list = [None] * depth
        self.turn = 0
        self.stream = _side_stream(device)

    def copy(self, src: np.ndarray, dst: torch.Tensor) -> torch.cuda.Event:
        """Enqueue the copy of the C-contiguous host array `src` into the
        contiguous device tensor `dst` of the same byte size, chunk by chunk
        on the side stream. Returns the event recorded after the last chunk."""
        flat = host_tensor(np.ascontiguousarray(src).reshape(-1).view(np.uint8))
        out = dst.reshape(-1).view(torch.uint8)
        if flat.numel() != out.numel():
            raise ValueError(f"ring copy of {flat.numel()} bytes into {out.numel()}")
        done = torch.cuda.Event()
        done.record(self.stream)  # an empty source is complete at once
        for off in range(0, flat.numel(), self.chunk_bytes):
            m = min(self.chunk_bytes, flat.numel() - off)
            i = self.turn
            self.turn = (i + 1) % len(self.bufs)
            if self.events[i] is not None:
                self.events[i].synchronize()  # the DMA out of buffer i has finished
            buf = self.bufs[i][:m]
            buf.copy_(flat[off : off + m])
            with torch.cuda.stream(self.stream):
                out[off : off + m].copy_(buf, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            self.events[i] = done
        return done


def upload(block: np.ndarray, device: torch.device, dtype: torch.dtype,
           ring: Optional[PinnedRing] = None, rows: Optional[int] = None) -> torch.Tensor:
    """The host block on `device` in `dtype`. On the CPU: the block itself,
    shared (a cast allocates a new tensor). On the card: a device tensor of
    `rows` rows (at least the block's; rows past the block's are left as the
    allocator hands them over) filled through `ring`, ready on the current
    stream, then cast there."""
    if device.type == "cpu":
        t = host_tensor(np.ascontiguousarray(block))
        return t if t.dtype == dtype else t.to(dtype)
    t0 = time.perf_counter()
    if ring is None:
        raise ValueError("an upload to the card goes through a PinnedRing")
    n = block.shape[0]
    rows = n if rows is None else int(rows)
    if rows < n:
        raise ValueError(f"an upload of {n} rows into {rows}")
    src_dtype = host_tensor(np.empty(0, block.dtype)).dtype
    compute = torch.cuda.current_stream(device)
    out = torch.empty((rows,) + tuple(block.shape[1:]), dtype=src_dtype, device=device)
    ring.stream.wait_stream(compute)
    done = ring.copy(block, out[:n])
    compute.wait_event(done)
    counters["h2d_bytes"] += block.nbytes
    counters["h2d_s"] += time.perf_counter() - t0
    return out if out.dtype == dtype else out.to(dtype)
