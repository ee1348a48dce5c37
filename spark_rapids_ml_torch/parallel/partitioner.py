#
# Rank bookkeeping and the collectives of a multi-process fit (the counterpart
# of the JAX package's parallel/partitioner.py: `Partitioner` and
# `active_partitioner`). The JAX package installs partitioners that carry a
# mesh; here the default process group is the only state, so there is no
# install registry: `active_partitioner` reads the group.
#
# The contract is the reference's barrier contract: each rank holds its own
# partition of the rows, stages and streams only those, and every rank ends
# with the same model. Model state (covariance, normal equations, centers)
# is replicated, so the fits are all-reduce shaped: each `psum` of the JAX
# package becomes one all-reduce SUM of the same partial statistics here, and
# the collective bytes are proportional to the state, never to the data. Two
# all-reduces take the MAX: the streamed-or-in-core flag (`any`) and
# LinearRegression's column ranges (ops/linear.py::constant_columns). The
# forests add their level histograms the same way (ops/trees.py).
#
# Exact kNN is the exception: its model is the item set, which stays sharded
# (each rank holds its own items, as the reference's item_df is
# distributed). Its two routes exchange candidates or items instead
# (ops/knn.py): `all_gather_rows` gathers every rank's candidate lists, and
# `ring_shift` (jax.lax.ppermute with i -> i + 1 mod P) passes each
# rank's item shard to the next rank, one point-to-point send and receive a
# rank (dist.batch_isend_irecv, which gloo and NCCL both take). DBSCAN's
# transform, which clusters every rank's rows, passes each rank's row shard
# round the same ring, for the core count and for each propagation round, and
# all-gathers the labels (ops/dbscan.py). Both hold their shard in a `Ring`:
# the rank's tensors padded to the largest rank's rows, and the rank that owns
# the shard held.
#
# The JAX package's parallel/mesh.py has no counterpart: one process drives one
# device (parallel/bootstrap.py), so there is no mesh inside a rank.
#
# Where the payloads go. Under NCCL every collective runs on the rank's card.
# Under gloo (the CPU, or ranks sharing a card) every payload goes through the
# host: a CUDA tensor is copied to the CPU, reduced or gathered there, and
# copied back (gloo's all_gather takes CPU tensors only). Every payload on
# this path is a small statistic, a row count, a sample (the KMeans init's
# strided one, the forest's edge sample) or kNN's queries and candidates, so
# the copies cost little; the ring's shards are the exception (60% of
# 1,048,576 x 256 f32 kNN items is 0.64 GB a hop; 60% of 262,144 x 32 DBSCAN
# rows 20 MB a hop, P - 1 hops for the count and P - 1 a round), which NCCL
# moves card to card.
#
# Counters (`counters`, zeroed by `reset_counters`), under the JAX package's
# names: comm.collective_ops (one per collective) and comm.collective_bytes
# (the bytes this rank contributed). A single process makes no collective.
#

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import config as _config
from ..utils import span
from .partition import PartitionDescriptor

counters: Dict[str, int] = {}


def reset_counters() -> None:
    counters.update({"comm.collective_ops": 0, "comm.collective_bytes": 0})


reset_counters()


class Partitioner:
    """This rank's place in the default process group (one rank when there is
    none) and the collectives of a fit across the group."""

    @property
    def is_multiprocess(self) -> bool:
        return self.process_count > 1

    @property
    def process_index(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def process_count(self) -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    def _comm_device(self) -> torch.device:
        """Where the collectives' payloads go (module header)."""
        if dist.get_backend() == "gloo":
            return torch.device("cpu")
        return torch.device("cuda", torch.cuda.current_device())

    def _count(self, t: torch.Tensor) -> None:
        counters["comm.collective_ops"] += 1
        counters["comm.collective_bytes"] += t.numel() * t.element_size()

    def ranks_on_device(self) -> int:
        """How many ranks of the group drive this rank's card (ranks share a
        card when there are more ranks than cards): the card's share of each."""
        if not self.is_multiprocess or not torch.cuda.is_available():
            return 1
        cards = torch.cuda.device_count()
        return sum(1 for r in range(self.process_count)
                   if r % cards == self.process_index % cards)

    def _all_reduce(self, op, tensors: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
        """One all-reduce `op` of tensors of one dtype on one device, packed
        into a single flat payload. Every rank gets the same bits. One
        process: the tensors as they are."""
        if not self.is_multiprocess:
            return tensors
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) != 1:
            raise TypeError(f"an all-reduce packs tensors of one dtype, got {sorted(map(str, dtypes))}")
        device = tensors[0].device
        flat = torch.cat([t.reshape(-1) for t in tensors]).to(self._comm_device())
        self._count(flat)
        dist.all_reduce(flat, op=op)
        flat = flat.to(device)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at : at + t.numel()].view(t.shape))
            at += t.numel()
        return tuple(out)

    def all_reduce_sum(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The element-wise sums over the ranks, in one all-reduce."""
        return self._all_reduce(dist.ReduceOp.SUM, tensors)

    def all_reduce_max(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The element-wise maxima over the ranks, in one all-reduce."""
        return self._all_reduce(dist.ReduceOp.MAX, tensors)

    def any(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on any (an all-reduce MAX)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int64)
        return bool(self.all_reduce_max(t)[0].item())

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s tensor on every rank, on the device each passed it on;
        every rank passes a tensor of the same shape and dtype."""
        if not self.is_multiprocess:
            return tensor
        t = tensor.contiguous().to(self._comm_device())
        self._count(t)
        dist.broadcast(t, src=src)
        return t.to(tensor.device)

    def all_gather_ints(self, *values: int) -> List[Tuple[int, ...]]:
        """Every rank's `values`, in rank order, by one all-gather."""
        if not self.is_multiprocess:
            return [tuple(int(v) for v in values)]
        mine = torch.tensor([int(v) for v in values], dtype=torch.int64, device=self._comm_device())
        parts = [torch.empty_like(mine) for _ in range(self.process_count)]
        self._count(mine)
        dist.all_gather(parts, mine)
        return [tuple(int(v) for v in p.tolist()) for p in parts]

    def all_gather_rows(self, t: torch.Tensor, rows: Optional[List[int]] = None) -> torch.Tensor:
        """Every rank's rows of `t` (the same trailing shape and dtype on every
        rank, any number of rows, 0 included), concatenated in rank order on
        t's device: one all-gather of the row counts, one of the rows padded
        to the longest part. `rows`, every rank's row count in rank order,
        saves the first when the caller knows them."""
        if not self.is_multiprocess:
            return t
        if rows is None:
            rows = [r for (r,) in self.all_gather_ints(t.shape[0])]
        if rows[self.process_index] != t.shape[0]:
            raise ValueError(f"rank {self.process_index} holds {t.shape[0]} rows, not {rows[self.process_index]}")
        most = max(rows)
        mine = torch.zeros((most,) + tuple(t.shape[1:]), dtype=t.dtype, device=self._comm_device())
        mine[: t.shape[0]] = t.to(mine.device)
        parts = [torch.empty_like(mine) for _ in rows]
        self._count(mine)
        dist.all_gather(parts, mine)
        return torch.cat([p[:r] for p, r in zip(parts, rows)]).to(t.device)

    def ring_shift(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The ring step of jax.lax.ppermute with the permutation i -> i + 1
        mod P: this rank sends its tensors to rank + 1 and returns rank - 1's,
        which have the same shapes and dtypes, on the devices each was given
        on. One batch of point-to-point sends and receives, counted as one
        collective. One process: the tensors as they are."""
        if not self.is_multiprocess:
            return tensors
        rank, count = self.process_index, self.process_count
        sends = [t.contiguous().to(self._comm_device()) for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        counters["comm.collective_ops"] += 1
        counters["comm.collective_bytes"] += sum(t.numel() * t.element_size() for t in sends)
        ops = [dist.P2POp(dist.isend, t, (rank + 1) % count) for t in sends]
        ops += [dist.P2POp(dist.irecv, t, (rank - 1) % count) for t in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(r.to(t.device) for r, t in zip(recvs, tensors))

    def descriptor(self, n_rows: int, n_cols: int) -> PartitionDescriptor:
        """The global layout from one all-gather of every rank's (rows, cols):
        this rank's rows are global rows [desc.offset, desc.offset + n_rows).
        A rank with no rows may not know the width; the ranks with rows must
        agree on it."""
        shapes = self.all_gather_ints(n_rows, n_cols)
        widths = {c for r, c in shapes if r > 0}
        if len(widths) > 1:
            raise ValueError(f"the ranks' feature widths differ: {[c for _, c in shapes]}")
        width = widths.pop() if widths else int(n_cols)
        rows = [r for r, _ in shapes]
        return PartitionDescriptor.build(rows, width, rank=self.process_index, padded_m=sum(rows))


class Ring:
    """The shard a rank holds on the ring of `Partitioner.ring_shift`: its
    tensors, given as (tensor, fill) pairs, padded with the fill to the
    largest rank's rows (`rows`, every rank's row count in rank order), and
    the rank that owns the shard held. `starts` are the ranks' first global
    rows."""

    def __init__(self, part: Partitioner, rows: List[int], *padded: Tuple[torch.Tensor, float]):
        self.part, self.rows = part, list(rows)
        self.starts = [sum(self.rows[:r]) for r in range(len(self.rows))]
        shard = max(self.rows)
        self.tensors: List[torch.Tensor] = []
        for t, fill in padded:
            full = torch.full((shard,) + tuple(t.shape[1:]), fill, dtype=t.dtype, device=t.device)
            full[: t.shape[0]] = t
            self.tensors.append(full)
        self.owner = part.process_index

    def hops(self):
        """Yields once for every rank's shard, the one held first, passing the
        shard on in between (P - 1 shifts, one collective each): the rank that
        owns the shard held, whose tensors are then `self.tensors`."""
        for h in range(len(self.rows)):
            if h:
                with span("exchange", route="ring"):
                    self.tensors = list(self.part.ring_shift(*self.tensors))
                self.owner = (self.owner - 1) % len(self.rows)
            yield self.owner


def active_partitioner() -> Partitioner:
    """The partitioner over the default process group (a single process when
    there is none)."""
    return Partitioner()


def resolve_batch_rows_per_process(part: Optional[Partitioner] = None) -> int:
    """Rows per streamed batch on each rank: the single-process
    `stream_batch_rows` split across the ranks, so one streamed step of the
    group covers a global batch."""
    part = part if part is not None else active_partitioner()
    total = int(_config.get("stream_batch_rows"))
    return max(1, total // max(1, part.process_count))

