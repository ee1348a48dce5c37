#
# Fused distance + running smallest-k scan, exact kNN's kernel (counterpart of
# the top-k half of the JAX package's ops/pallas_select.py: _topk_scan_kernel,
# _fused_topk_scan, fused_topk_pinned, fused_topk, oversample_width,
# fused_probe): per
# query row, the k items with the smallest max(q2 − 2·q·x + x2, 0), ascending,
# invalid items at INVALID_D2, ties lowest id first, as (f32 d2, int32 ids).
#
# `precision` picks the form of the cross term q·x, as the TPU kernel's
# `_cross_term` does: "float32" (exact), "bfloat16" (operands rounded to bf16,
# f32 sums) or "int8" (per-row symmetric int8 quantization, exact int32 sums,
# rescaled). The two narrow forms rank an approximate candidate pool; their
# caller widens it (`oversample_width`) and re-ranks it in exact f32
# (ops/knn.py). Their item operand (`narrow_rows`: the bf16 or int8 copy,
# rows zero-padded to a whole 16 bytes, and the int8 scales) may be made once
# per item set and passed in.
#
# `fused_probe` (the JAX package's fused_probe) is the IVF coarse probe: few
# items (the nlist centers), many queries, k = nprobe, exact f32, any nprobe
# from 1 to nlist. On the card it launches its own kernel, csrc/probe.cu (a
# 3xTF32 distance tile into a (queries, nlist) scratch, then a bucket select
# and a counting sort a query row), never the scan; on the CPU its plain
# version is `topk_plain` with every center valid, the JAX package's
# exact_full probe (ann_streaming.py::_probe_cells). `probe_plan` cuts the
# queries into blocks whose scratch stays within PROBE_SCRATCH_BYTES, on
# both devices. Both IVF searches of the port (ops/knn.py::ivfflat_search
# and ivfpq_search in-core, ops/ann_streaming.py::streaming_ivfflat_search
# out-of-core) probe through it. The JAX package routes only its streamed
# search through fused_probe (and only under knn.selection=pallas_fused) and
# probes in-core with the XLA exact_full scan; its docstring states the two
# give the same ids, so the port's one route is a route, not a change of
# result.
#
# `fused_topk` launches a CUDA kernel for tensors on the card, always (the JAX
# package's `knn.pallas_min_items` gate is a fact about the TPU), and runs
# `topk_plain`, the same function in plain PyTorch, for tensors on the CPU.
# The float32 form is csrc/topk.cu, its products in 3xTF32 on the tensor
# cores, at f32 accuracy; the TPU kernel's tile geometry (q_block, item_tile,
# the VMEM budget) has no counterpart: the card's geometry is fixed in the
# source, and the wrapper only splits the items into ranges (`_splits`) so
# that query tiles x ranges fill whole waves of the card's resident blocks.
# The bfloat16 and int8 forms are csrc/topk_narrow.cu (a TMA ring of item
# chunks, the query tile resident, wgmma in one or two consumer warpgroups);
# `narrow_plan` sizes its launch from the pool width and the padded width:
# consumer warpgroups, the resident or streamed query tile, the ring's depth,
# and the item ranges by the same rule. Each source's header has its design
# and its bound on the H100.
#

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _cuda
from .knn import _block_sq_dists, center_norms_sq, query_blocks
from .selection import mask_invalid, select_topk

K_MAX = 256  # the kernel's largest k (TOPK_K_MAX in csrc/topk.cu)
Q_TILE = 64  # csrc/topk.cu QT: queries per block
ITEM_TILE = 128  # csrc/topk.cu IT: items per tile of a range
MAX_SPLITS = 512  # item ranges at most
MIN_SPLIT_ITEMS = 4096  # a range scans at least this many items
MAX_WAVES = 16  # past this many waves the rule stops splitting for whole waves
SMEM_BLOCK = 232_448  # H100: shared memory one block can use
# the forms of the products; the narrow ones' codes are csrc/topk_narrow.cu FORM_*
MODES = {"float32": 0, "bfloat16": 1, "int8": 2}
# columns at which an int8 row's int32 sum of 127 * 127 products cannot overflow
INT8_D_MAX = (2**31 - 1) // (127 * 127)
QUANT_ROWS = 1 << 20  # rows converted at a time by narrow_rows
# csrc/topk_narrow.cu's geometry (narrow_smem_bytes)
NARROW_Q_TILE = 64  # QW: queries of a consumer warpgroup
NARROW_CHUNK_BYTES = 128  # CHUNK_BYTES: bytes of a row a ring stage holds
NARROW_BUFFER_KEYS = 32  # BCAP: candidate keys buffered a query
NARROW_MIN_STAGES = 2  # the ring's least depth
# Pins the number of item ranges (1 to MAX_SPLITS) in place of `_splits`'s
# rule, for timing the rule against one range; None keeps the rule.
_pin_splits: Optional[int] = None


class NarrowRows(NamedTuple):
    """A narrow form's operand: (m, dp) bf16 or int8 rows, zero-padded from d
    to a whole 16 bytes, and for int8 the (m,) f32 row scales."""

    rows: torch.Tensor
    scales: Optional[torch.Tensor]


def oversample_width(k: int, n: int, precision: str) -> int:
    """Candidate-pool width of a form (the JAX package's oversample_width):
    k for float32, which is exact; k + max(8, k // 4) for the narrow forms,
    whose ranking error can push a true neighbor just past the k-th place.
    Clamped to n."""
    if precision == "float32":
        return min(int(k), n)
    return min(n, int(k) + max(8, int(k) // 4))


def quantize_rows(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization, as the TPU kernel's _cross_term
    takes it, op for op: s = max |row| / 127, q = round(row / max(s, 1e-30))
    (a division; round half to even). Returns (q int8, s f32)."""
    s = torch.amax(torch.abs(A), dim=1) / 127.0
    q = torch.round(A / torch.clamp(s, min=1e-30)[:, None]).to(torch.int8)
    return q, s


def narrow_rows(A: torch.Tensor, precision: str) -> NarrowRows:
    """The operand of the "bfloat16" or "int8" form for the f32 rows of A
    (m, d): rounded to bf16 (to nearest even) or quantized (quantize_rows),
    zero-padded to dp columns (8 bf16 or 16 int8: zeros add nothing to a dot
    product), QUANT_ROWS rows at a time."""
    m, d = A.shape
    if precision not in ("bfloat16", "int8"):
        raise ValueError(f"narrow_rows takes 'bfloat16' or 'int8', got {precision!r}")
    bf16 = precision == "bfloat16"
    per = 8 if bf16 else 16
    dp = -(-d // per) * per
    rows = torch.zeros((m, dp), dtype=torch.bfloat16 if bf16 else torch.int8, device=A.device)
    scales = None if bf16 else torch.empty((m,), dtype=torch.float32, device=A.device)
    for r0 in range(0, m, QUANT_ROWS):
        part = A[r0 : r0 + QUANT_ROWS]
        if bf16:
            rows[r0 : r0 + QUANT_ROWS, :d] = part.to(torch.bfloat16)
        else:
            rows[r0 : r0 + QUANT_ROWS, :d], scales[r0 : r0 + QUANT_ROWS] = quantize_rows(part)
    return NarrowRows(rows, scales)


def topk_plain(
    Q: torch.Tensor, X: torch.Tensor, valid: torch.Tensor, k: int,
    x2: Optional[torch.Tensor] = None, block: Optional[int] = None,
    precision: str = "float32", items: Optional[NarrowRows] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, the counterpart of the JAX
    package's blocked `_exact_knn_scan` with exact_full selection: per query
    block, `_block_sq_dists` against all items, the sentinel mask, and
    `select_topk` (which clamps at the sentinel). k is clamped to n. The
    narrow forms take their cross term as _cross_term does (bf16 products
    exact in f32 and summed in f32; int8 products summed exactly, in f32
    while d * 127^2 <= 2^24 and else in f64, then (sum * s_q) * s_x) and then
    the same ops in the same order: −2·cross + q2 + x2, max(., 0), the mask,
    the clamp. `items` is X's narrow operand when the caller holds one."""
    nq, n = Q.shape[0], X.shape[0]
    k = min(int(k), n)
    if x2 is None:
        x2 = center_norms_sq(X)
    d2_out = torch.empty((nq, k), dtype=torch.float32, device=Q.device)
    id_out = torch.empty((nq, k), dtype=torch.int32, device=Q.device)
    if precision == "float32":
        for sl in query_blocks(nq, n, block):
            d2 = mask_invalid(_block_sq_dists(Q[sl], X, x2), valid[None, :])
            d2_out[sl], id_out[sl] = select_topk(d2, k)
        return d2_out, id_out
    Xn = narrow_rows(X, precision) if items is None else items
    Qn = narrow_rows(Q, precision)
    exact_f32 = Xn.rows.shape[1] * 127 * 127 <= 2**24
    Xw = Xn.rows.to(torch.float32 if precision == "bfloat16" or exact_f32 else torch.float64)
    q2 = torch.sum(Q * Q, dim=1, keepdim=True)
    for sl in query_blocks(nq, n, block):
        cross = torch.matmul(Qn.rows[sl].to(Xw.dtype), Xw.T).float()
        if precision == "int8":
            cross.mul_(Qn.scales[sl, None]).mul_(Xn.scales[None, :])
        d2 = cross.mul_(-2.0).add_(q2[sl]).add_(x2).clamp_(min=0.0)
        d2_out[sl], id_out[sl] = select_topk(mask_invalid(d2, valid[None, :]), k)
    return d2_out, id_out


def _buffer_keys(k: int) -> int:
    """Candidate keys buffered per query at k: 64 where they fit beside the
    pools in one block's shared memory, else 32 (csrc/topk.cu srml_topk)."""
    return 64 if _smem_bytes(k, 64) <= SMEM_BLOCK else 32


def _smem_bytes(k: int, buffer_keys: Optional[int] = None) -> int:
    """Dynamic shared memory of the scan kernel at k (csrc/topk.cu
    scan_smem_bytes): the pools of 64 queries (k 8-byte keys each), their
    buffers, k-th keys and k-th d2, the 3-stage ring of (64 + 128) x 36
    floats, and the buffers' counts."""
    b = _buffer_keys(k) if buffer_keys is None else buffer_keys
    ring = 3 * (Q_TILE + ITEM_TILE) * 36
    return 8 * (Q_TILE * k + Q_TILE * b + Q_TILE) + 4 * (Q_TILE + ring + Q_TILE)


def _splits(nq: int, n: int, k: int, sms: int, q_tile: int = Q_TILE) -> Tuple[int, int]:
    """(n_splits, items per split, a whole number of item tiles). The fewest
    ranges for which query tiles (of q_tile queries) x ranges is a whole
    number of waves of the card's resident blocks, unless that takes more
    than MAX_WAVES waves (then enough ranges for MAX_WAVES), each range at
    least MIN_SPLIT_ITEMS items; `_pin_splits` pins the count in place of the
    rule. One block is resident per SM (the f32 scan: its shared memory at
    k = 200, its 512 threads' registers at every k; the narrow scan: its
    ring takes what the pools leave)."""
    n_splits = _pin_splits
    if n_splits is None:
        tiles = -(-nq // q_tile)
        n_splits = sms // math.gcd(tiles, sms)
        if tiles * n_splits > MAX_WAVES * sms:
            n_splits = -(-MAX_WAVES * sms // tiles)
        n_splits = max(1, min(n_splits, MAX_SPLITS, n // MIN_SPLIT_ITEMS))
    elif not 1 <= n_splits <= MAX_SPLITS:
        raise ValueError(f"_pin_splits must be 1 to {MAX_SPLITS}, got {n_splits}")
    per = -(-n // n_splits)
    per = -(-per // ITEM_TILE) * ITEM_TILE
    return -(-n // per), per


class NarrowPlan(NamedTuple):
    """How csrc/topk_narrow.cu runs a narrow form: `consumers` warpgroups of
    NARROW_Q_TILE queries a block (`q_block` queries), the query tile
    `resident` in shared memory or streamed through the ring beside the
    items, a ring of `stages` stages of NARROW_CHUNK_BYTES of each of a
    tile's ITEM_TILE item rows, `chunks` stages to a tile's padded width,
    `smem` bytes of dynamic shared memory, and `n_splits` item ranges of
    `per` items (`_splits`)."""

    consumers: int
    resident: bool
    stages: int
    chunks: int
    smem: int
    q_block: int
    n_splits: int
    per: int

    def blocks(self, nq: int, n: int):
        """Each block's (query slice, item slice), in launch order: the query
        blocks fastest (blockIdx.x % query blocks), as the kernel reads them."""
        q_blocks = -(-nq // self.q_block)
        for b in range(q_blocks * self.n_splits):
            q, r = b % q_blocks, b // q_blocks
            yield (slice(q * self.q_block, min((q + 1) * self.q_block, nq)),
                   slice(r * self.per, min((r + 1) * self.per, n)))


def narrow_smem_bytes(consumers: int, k: int, stages: int, chunks: int, resident: bool) -> int:
    """Dynamic shared memory of the narrow scan (csrc/topk_narrow.cu
    narrow_smem_bytes): 1 KB of alignment slack, the resident query chunks
    (64 rows x 128 bytes each), the ring (a stage: 128 item rows x 128 bytes,
    plus the query chunks when they stream), the pools, buffers, k-th keys and
    shared bounds of each warpgroup's 64 queries, two mbarriers a stage, one
    for the queries and a count, the k-th d2 and the buffers' counts, and
    each warpgroup's copy of a tile's item norms and scales."""
    q_chunk = NARROW_Q_TILE * NARROW_CHUNK_BYTES
    queries = consumers * chunks * q_chunk if resident else 0
    stage = ITEM_TILE * NARROW_CHUNK_BYTES + (0 if resident else consumers * q_chunk)
    keys = consumers * NARROW_Q_TILE * (k + NARROW_BUFFER_KEYS + 2) + 2 * stages + 2
    return (1024 + queries + stages * stage + 8 * keys + 8 * consumers * NARROW_Q_TILE
            + 8 * consumers * ITEM_TILE)


def narrow_plan(nq: int, n: int, dp: int, precision: str, k: int, sms: int) -> NarrowPlan:
    """The narrow scan's launch plan for nq queries against n items of dp
    padded columns in `precision` ("bfloat16" or "int8") at pool width k. The
    first of (two warpgroups, resident queries), (one, resident), (one,
    streamed) whose shared memory leaves the ring at least NARROW_MIN_STAGES
    stages; the ring as deep as one block's shared memory (SMEM_BLOCK)
    allows; the item ranges by `_splits` with the block's queries as its
    query tile."""
    if precision not in ("bfloat16", "int8"):
        raise ValueError(f"narrow_plan takes 'bfloat16' or 'int8', got {precision!r}")
    esize = 2 if precision == "bfloat16" else 1
    chunks = -(-dp * esize // NARROW_CHUNK_BYTES)
    for consumers, resident in ((2, True), (1, True), (1, False)):
        fixed = narrow_smem_bytes(consumers, k, 0, chunks, resident)
        per_stage = narrow_smem_bytes(consumers, k, 1, chunks, resident) - fixed
        stages = (SMEM_BLOCK - fixed) // per_stage if SMEM_BLOCK > fixed else 0
        if stages >= NARROW_MIN_STAGES:
            break
    else:  # not reached for k <= K_MAX: one streamed warpgroup needs some 200 KB
        raise ValueError(f"no narrow scan plan fits one block at k = {k}")
    q_block = consumers * NARROW_Q_TILE
    n_splits, per = _splits(nq, n, k, sms, q_block)
    return NarrowPlan(
        consumers=consumers, resident=resident, stages=stages, chunks=chunks,
        smem=narrow_smem_bytes(consumers, k, stages, chunks, resident), q_block=q_block,
        n_splits=n_splits, per=per,
    )


def fused_topk(
    Q: torch.Tensor, X: torch.Tensor, valid: torch.Tensor, k: int,
    *, x2: Optional[torch.Tensor] = None, precision: str = "float32",
    items: Optional[NarrowRows] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest rows of X (n, d) f32 with valid (n,) bool for each row of
    Q (nq, d) f32: (d2 (nq, k) f32 ascending, ids (nq, k) int32). k is clamped
    to n and may be at most K_MAX after that. `x2` (n,) f32 is the items'
    cached squared norms. `precision` is the form of the products (MODES); a
    narrow form returns the pool of its approximate ranking, and `items` is
    X's narrow operand (narrow_rows) when the caller holds one. On CUDA
    tensors csrc/topk.cu (float32) or csrc/topk_narrow.cu (the narrow forms,
    launched by `narrow_plan`), counted on LAUNCH_COUNTERS[precision]; on CPU
    tensors topk_plain."""
    nq, d = Q.shape
    n = X.shape[0]
    _cuda.require(Q, "Q", (nq, d))
    _cuda.require(X, "X", (n, d))
    _cuda.require(valid, "valid", (n,), dtype=torch.bool)
    if x2 is not None:
        _cuda.require(x2, "x2", (n,))
    if precision not in MODES:
        raise ValueError(f"precision must be one of {tuple(MODES)}, got {precision!r}")
    if items is not None:
        dp = items.rows.shape[1]
        want = torch.bfloat16 if precision == "bfloat16" else torch.int8
        _cuda.require(items.rows, "items.rows", (n, dp), dtype=want)
        if precision == "int8":
            _cuda.require(items.scales, "items.scales", (n,))
    if n < 1 or n >= 2**31:
        raise ValueError(f"the top-k kernel takes 1 to 2^31 - 1 items, got {n}")
    k = min(int(k), n)
    if not 1 <= k <= K_MAX:
        raise ValueError(f"the top-k kernel takes k from 1 to K_MAX = {K_MAX}, got {k}")
    tensors = (Q, X, valid) if x2 is None else (Q, X, valid, x2)
    if _cuda.device_kind(*tensors) == "cpu":
        return topk_plain(Q, X, valid, k, x2, precision=precision, items=items)
    if precision == "float32":
        q2, x2m = _norms(Q, X, valid, x2)
        n_splits, per = _splits(nq, n, k, _cuda.sm_count(Q))
        d2_out, id_out, part, scratch = _outputs(Q, k, n_splits)
        _cuda.check(
            _cuda.entry("topk")(
                Q.data_ptr(), q2.data_ptr(), nq, d, X.data_ptr(), x2m.data_ptr(), n, k, n_splits,
                per, part.data_ptr(), scratch.data_ptr(), d2_out.data_ptr(), id_out.data_ptr(),
                _cuda.stream_of(Q)),
            "top-k kernel (float32)",
        )
    else:
        d2_out, id_out = _narrow_scan(Q, X, valid, k, x2, precision, items)
    _cuda.count_launch(fused_topk, LAUNCH_COUNTERS[precision])
    return d2_out, id_out


def _norms(Q, X, valid, x2):
    """The queries' squared norms and the items' with the mask in them: an
    invalid item's norm reads -1."""
    if x2 is None:
        x2 = center_norms_sq(X)
    return torch.sum(Q * Q, dim=1), torch.where(valid, x2, -1.0)


def _outputs(Q, k, n_splits):
    """(d2 (nq, k) f32, ids (nq, k) int32, part, scratch): with several item
    ranges each range's pool of k keys and the merge's two rounds of scratch,
    else d2 again (not read)."""
    nq = Q.shape[0]
    d2_out = torch.empty((nq, k), dtype=torch.float32, device=Q.device)
    id_out = torch.empty((nq, k), dtype=torch.int32, device=Q.device)
    part = scratch = d2_out
    if n_splits > 1:
        half = -(-n_splits // 2)
        part = torch.empty((n_splits, nq, k), dtype=torch.int64, device=Q.device)
        scratch = torch.empty((nq, half + -(-half // 2), k), dtype=torch.int64, device=Q.device)
    return d2_out, id_out, part, scratch


def _narrow_scan(Q, X, valid, k, x2, precision, items, *, products_only=False):
    """csrc/topk_narrow.cu on CUDA tensors as `fused_topk` checked them (k
    clamped), launched by `narrow_plan` and not counted: (d2, ids).
    products_only=True is a timing variant that skips the epilogue (its
    result is then meaningless), for chip_smoke.py alone."""
    nq, n = Q.shape[0], X.shape[0]
    q2, x2m = _norms(Q, X, valid, x2)
    Xn = narrow_rows(X, precision) if items is None else items
    Qn = narrow_rows(Q, precision)
    dp = Xn.rows.shape[1]
    if precision == "int8" and dp > INT8_D_MAX:
        raise ValueError(f"the int8 form takes at most {INT8_D_MAX} columns, got {Q.shape[1]}")
    plan = narrow_plan(nq, n, dp, precision, k, _cuda.sm_count(Q))
    d2_out, id_out, part, scratch = _outputs(Q, k, plan.n_splits)
    # the scales are read by the int8 form only; with several ranges, each
    # query's shared bounds (csrc/topk_narrow.cu), all ones at first
    qs, xs = (Qn.scales, Xn.scales) if precision == "int8" else (q2, x2m)
    bound = part if plan.n_splits == 1 else torch.full((plan.n_splits + 1, nq), -1,
                                                       dtype=torch.int64, device=Q.device)
    # the largest finite valid item norm, which the kernel's row filter takes
    # its slack from
    x2max = torch.where(valid & torch.isfinite(x2m), x2m, 0.0).amax().reshape(1)
    _cuda.check(
        _cuda.entry("topk_narrow")(
            Qn.rows.data_ptr(), q2.data_ptr(), nq, dp, Xn.rows.data_ptr(), x2m.data_ptr(), n, k,
            plan.n_splits, plan.per, plan.consumers, plan.stages, int(plan.resident),
            part.data_ptr(), scratch.data_ptr(), d2_out.data_ptr(), id_out.data_ptr(),
            MODES[precision], qs.data_ptr(), xs.data_ptr(), x2max.data_ptr(),
            int(products_only), bound.data_ptr(), _cuda.stream_of(Q)),
        f"top-k kernel ({precision})",
    )
    return d2_out, id_out


# a launch counter a form
LAUNCH_COUNTERS = {"float32": "launches", "bfloat16": "bf16_launches", "int8": "int8_launches"}
fused_topk.launches = 0
fused_topk.bf16_launches = 0
fused_topk.int8_launches = 0


# csrc/probe.cu's geometry and shared memory (srml_probe)
PROBE_Q_TILE = 128  # PQT: queries per block of the distance pass
PROBE_C_TILE = 128  # PCT: centers per block of the distance pass
# select_smem_bytes without the row and the sort buffer: 3 x SEL_BINS (1,024)
# ints, 2 x SEL_WARPS (8) and 4
PROBE_SEL_FIXED = 4 * (3 * 1024 + 2 * 8 + 4)
# The d2 scratch of one launch (and its device-memory sort buffer when the
# survivors do not fit in shared memory): the queries of a launch are as many
# as keep it within this, at least one.
PROBE_SCRATCH_BYTES = 256 << 20


class ProbePlan(NamedTuple):
    """How fused_probe runs nq queries against nlist centers at nprobe
    (csrc/probe.cu): `sort_size` the power of two of the survivors' buffer
    (its bitonic sort takes them when the counting sort's bins crowd);
    `row_smem` / `sort_smem` whether pass 2 holds a query's row of keys and
    that buffer in shared memory (else device memory); `q_block`
    queries a launch, `n_blocks` launches; `grid` the distance pass's
    (query tiles, center tiles) of a full launch; `select_smem` pass 2's
    dynamic shared memory; `scratch_bytes` the scratch of a launch."""

    nprobe: int
    sort_size: int
    row_smem: bool
    sort_smem: bool
    q_block: int
    n_blocks: int
    grid: Tuple[int, int]
    select_smem: int
    scratch_bytes: int

    def blocks(self, nq: int):
        """The query slices of the launches, in order."""
        for s in range(0, nq, self.q_block):
            yield slice(s, min(s + self.q_block, nq))


def probe_plan(nq: int, nlist: int, nprobe: int) -> ProbePlan:
    """The probe's plan (ProbePlan) for nq >= 0 queries, nlist >= 1 centers
    and 1 <= nprobe <= nlist. Pass 2 keeps the row and the sort buffer in
    shared memory when both fit in one block's, else the sort buffer alone,
    else neither. The queries of a launch: as many whole 128-query tiles as
    keep the scratch within PROBE_SCRATCH_BYTES, else as many queries, at
    least one."""
    if not 1 <= nprobe <= nlist:
        raise ValueError(f"probe_plan takes 1 <= nprobe <= nlist, got {nprobe} and {nlist}")
    P = 1 << (nprobe - 1).bit_length()
    sort_bytes = 8 * P  # the sort buffer
    if PROBE_SEL_FIXED + sort_bytes + 4 * nlist <= SMEM_BLOCK:
        row_smem, sort_smem = True, True
    elif PROBE_SEL_FIXED + sort_bytes <= SMEM_BLOCK:
        row_smem, sort_smem = False, True
    else:
        row_smem, sort_smem = False, False
    per_query = 4 * nlist + (0 if sort_smem else sort_bytes)
    fit = PROBE_SCRATCH_BYTES // per_query
    q_block = fit // PROBE_Q_TILE * PROBE_Q_TILE if fit >= PROBE_Q_TILE else fit
    q_block = max(1, min(max(nq, 1), q_block))
    return ProbePlan(
        nprobe=nprobe, sort_size=P, row_smem=row_smem, sort_smem=sort_smem, q_block=q_block,
        n_blocks=-(-nq // q_block),
        grid=(-(-q_block // PROBE_Q_TILE), -(-nlist // PROBE_C_TILE)),
        select_smem=(PROBE_SEL_FIXED + (sort_bytes if sort_smem else 0)
                     + (4 * nlist if row_smem else 0)),
        scratch_bytes=q_block * per_query,
    )


def probe_topk(
    Q: torch.Tensor, centers: torch.Tensor, nprobe: int,
    *, center_norms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fused_probe with the distances: (d2 (nq, p) f32 ascending, ids (nq, p)
    int32), p = min(nprobe, nlist), ties to the lower id. On CUDA tensors
    csrc/probe.cu, launched once a block of probe_plan and counted once a
    call on fused_probe.launches; on CPU tensors the plain version
    (topk_plain, every center valid) on the same blocks. nprobe below 1
    raises ValueError."""
    nq, d = Q.shape
    nlist = centers.shape[0]
    _cuda.require(Q, "Q", (nq, d))
    _cuda.require(centers, "centers", (nlist, d))
    if center_norms is not None:
        _cuda.require(center_norms, "center_norms", (nlist,))
    if nlist < 1 or nlist >= 2**31:
        raise ValueError(f"the IVF probe takes 1 to 2^31 - 1 centers, got {nlist}")
    if int(nprobe) < 1:
        raise ValueError(f"the IVF probe takes nprobe >= 1, got {nprobe}")
    nprobe = min(int(nprobe), nlist)
    tensors = (Q, centers) if center_norms is None else (Q, centers, center_norms)
    on_cpu = _cuda.device_kind(*tensors) == "cpu"
    cn = center_norms_sq(centers) if center_norms is None else center_norms
    plan = probe_plan(nq, nlist, nprobe)
    d2_out = torch.empty((nq, nprobe), dtype=torch.float32, device=Q.device)
    id_out = torch.empty((nq, nprobe), dtype=torch.int32, device=Q.device)
    if on_cpu:
        valid = torch.ones((nlist,), dtype=torch.bool)
        for sl in plan.blocks(nq):
            d2_out[sl], id_out[sl] = topk_plain(Q[sl], centers, valid, nprobe, cn)
        return d2_out, id_out
    if nq == 0:
        return d2_out, id_out
    fn = _cuda.entry("probe")
    keys = torch.empty((plan.q_block, nlist), dtype=torch.int32, device=Q.device)
    sort_buf = keys  # unread when the survivors are sorted in shared memory
    if not plan.sort_smem:
        sort_buf = torch.empty((plan.q_block, plan.sort_size), dtype=torch.int64, device=Q.device)
    for sl in plan.blocks(nq):
        _cuda.check(
            fn(Q[sl].data_ptr(), sl.stop - sl.start, d, centers.data_ptr(),
               cn.data_ptr(), nlist, nprobe, plan.sort_size, int(plan.row_smem),
               int(plan.sort_smem), keys.data_ptr(), sort_buf.data_ptr(), d2_out[sl].data_ptr(),
               id_out[sl].data_ptr(), _cuda.stream_of(Q)),
            "IVF probe kernel",
        )
    _cuda.count_launch(fused_probe, "launches")
    return d2_out, id_out


def fused_probe(
    Q: torch.Tensor, centers: torch.Tensor, nprobe: int,
    *, center_norms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """IVF coarse probe (the JAX package's fused_probe): (nq, min(nprobe,
    nlist)) int32 ids of each query's nearest centers, ascending, ties to the
    lower id, for every nprobe from 1 to nlist (probe_topk, its ids). The
    kernel csrc/probe.cu on the card; on the CPU its plain version, the JAX
    package's exact_full probe, _block_sq_dists and select_topk. The probe
    list bounds the recall of the whole search, so it is exact f32."""
    return probe_topk(Q, centers, nprobe, center_norms=center_norms)[1]


fused_probe.launches = 0  # the probe's launches, one a call on the card
