#
# Device-resident batch cache for multi-pass streamed fits (counterpart of the
# JAX package's ops/device_cache.py). Pass 1 of a multi-pass streamed fit
# (KMeans: one pass per Lloyd iteration) keeps the device batches that
# ops/streaming.py::_batch_stream uploaded; later passes replay them without
# touching the host. The pairwise tier's sweeps (ops/pairwise_streaming.py:
# a kNN search's query blocks, DBSCAN's core mask and rounds) replay their
# item tiles the same way. The contract is the JAX package's:
#
#   * whole-batch granularity: a batch is cached as the exact Batch the stream
#     yielded, so a replayed pass runs the same kernels on the same tensors and
#     its results are bit-identical to pure streaming;
#   * keyed by (site, the source arrays' identities, batch rows, device); the
#     key pins the source arrays for the cache's life, so an id() reused by a
#     later array never aliases a freed one's key;
#   * a byte budget (`cache.hbm_budget_bytes`, config.cache_budget_bytes) with
#     LRU eviction across streams and prefix semantics within one: when a
#     dataset exceeds the budget its leading batches stay and its tail streams
#     every pass, and a stream never evicts its own batches;
#   * a batch's tensors are never reused or written once cached: uploads
#     allocate each batch anew (ops/ingest.py), on the CPU they are views of
#     the pinned source or buffers the staging pool never hands out again.
#
# Lifecycle: core/estimator.py opens a `batch_cache()` scope around each
# streamed fit and frees it at the fit's exit; the streamed ops open one
# themselves and reuse the estimator's when one is open (a direct ops call
# gets a cache of its own).
#
# Counters (`counters`, zeroed by `reset_counters`): hits, misses, evictions,
# and bytes_resident, the bytes the open caches hold; uploads and
# upload_bytes, the batches `cached_build` had to build.
#
# Not ported: the serving plane's pins (`pin`, `unpin`, `replace`,
# `drop_stream`), which wait for the serving plane.
#

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from .. import config as _config
from ..utils import span

_tls = threading.local()

counters: Dict[str, int] = {}


def reset_counters() -> None:
    counters.update(hits=0, misses=0, evictions=0, uploads=0, upload_bytes=0,
                    bytes_resident=counters.get("bytes_resident", 0))


reset_counters()


def batch_nbytes(batch: Any) -> int:
    """Bytes of the tensors a batch holds."""
    return sum(int(t.nbytes) for t in batch.tensors())


class DeviceBatchCache:
    """Single-owner (one fit, one thread) replay cache of streamed device
    batches. Use it through `batch_cache()`."""

    def __init__(self, budget_bytes: int) -> None:
        self.budget_bytes = int(budget_bytes)
        self.bytes_resident = 0
        # (stream key, batch index) -> (batch, nbytes), least recently used first
        self._entries: "OrderedDict[Tuple[Any, int], Tuple[Any, int]]" = OrderedDict()
        # stream key -> its source arrays, pinned while the cache lives
        self._key_pins: Dict[Any, Sequence[Any]] = {}

    def stream_key(self, arrays: Sequence[Any], batch_rows: int, device: torch.device,
                   site: str = "ingest") -> Any:
        """Identity of one replayable stream: the source arrays (by pinned
        id), the batch rows and the device."""
        key = (site, tuple(id(a) for a in arrays), int(batch_rows), str(device))
        self._key_pins.setdefault(key, tuple(arrays))
        return key

    def contains(self, stream_key: Any, batch_index: int) -> bool:
        """Residency probe: no counting, no LRU touch."""
        return (stream_key, batch_index) in self._entries

    def get(self, stream_key: Any, batch_index: int) -> Optional[Any]:
        """The resident batch, or None (counted as a hit or a miss)."""
        entry = self._entries.get((stream_key, batch_index))
        if entry is None:
            counters["misses"] += 1
            return None
        self._entries.move_to_end((stream_key, batch_index))
        counters["hits"] += 1
        return entry[0]

    def put(self, stream_key: Any, batch_index: int, batch: Any) -> bool:
        """Keep a freshly streamed batch, evicting the least recently used
        batches of OTHER streams under budget pressure, never the inserting
        stream's own (prefix semantics). False when it does not fit."""
        if (stream_key, batch_index) in self._entries:
            return True
        nbytes = batch_nbytes(batch)
        if nbytes > self.budget_bytes:
            return False
        while self.bytes_resident + nbytes > self.budget_bytes:
            victim = next((k for k in self._entries if k[0] != stream_key), None)
            if victim is None:
                return False  # only this stream's prefix remains: stream the rest
            self._evict(victim)
        self._entries[(stream_key, batch_index)] = (batch, nbytes)
        self._resident(nbytes)
        return True

    def _resident(self, nbytes: int) -> None:
        self.bytes_resident += nbytes
        counters["bytes_resident"] += nbytes

    def _evict(self, entry_key: Tuple[Any, int]) -> None:
        _, nbytes = self._entries.pop(entry_key)
        self._resident(-nbytes)
        counters["evictions"] += 1

    def resident_batches(self) -> int:
        return len(self._entries)

    def close(self) -> None:
        """Drop every device reference and unpin the sources (not counted as
        evictions: a lifecycle free is not budget pressure)."""
        self._resident(-self.bytes_resident)
        self._entries.clear()
        self._key_pins.clear()


def cached_build(cache: Optional[DeviceBatchCache], cache_key: Any, batch_index: int,
                 build: Any) -> Any:
    """The cache-or-upload step of every streamed batch: a resident batch
    replays as it is; otherwise `build()` slices, stages and uploads it inside
    a `stream.ingest` span, the upload is counted, and the fresh batch is kept
    if the budget allows."""
    if cache is not None:
        hit = cache.get(cache_key, batch_index)
        if hit is not None:
            return hit
    with span("stream.ingest"):
        batch = build()
    counters["uploads"] += 1
    counters["upload_bytes"] += batch_nbytes(batch)
    if cache is not None:
        cache.put(cache_key, batch_index, batch)
    return batch


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def active_cache() -> Optional[DeviceBatchCache]:
    """The innermost open batch_cache() scope on this thread, if any."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def batch_cache(device: torch.device, in_flight_bytes: int = 0
                ) -> Iterator[Optional[DeviceBatchCache]]:
    """Per-fit cache scope. The outermost scope owns the cache (made from the
    config, freed at its exit); nested scopes reuse it. Yields None when
    `cache.enabled` is off or the budget (config.cache_budget_bytes, which on
    the card leaves room for `in_flight_bytes`) is 0: every pass then
    streams."""
    existing = active_cache()
    if existing is not None:
        yield existing
        return
    if not bool(_config.get("cache.enabled")):
        yield None
        return
    budget = _config.cache_budget_bytes(device, in_flight_bytes)
    if budget <= 0:
        yield None
        return
    cache = DeviceBatchCache(budget)
    _stack().append(cache)
    try:
        yield cache
    finally:
        _stack().remove(cache)
        cache.close()
