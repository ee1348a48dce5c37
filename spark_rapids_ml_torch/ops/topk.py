#
# Fused distance + running smallest-k scan, exact kNN's kernel (counterpart of
# the top-k half of the JAX package's ops/pallas_select.py: _topk_scan_kernel,
# _fused_topk_scan, fused_topk_pinned, fused_topk, oversample_width): per
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
# `fused_topk` launches the CUDA kernel csrc/topk.cu for tensors on the card,
# always (the JAX package's `knn.pallas_min_items` gate is a fact about the
# TPU), and runs `topk_plain`, the same function in plain PyTorch, for tensors
# on the CPU. The kernel takes its distance products in 3xTF32 on the tensor
# cores, at f32 accuracy; its design and its bound on the H100 are in the
# source's header. The TPU kernel's tile geometry (q_block, item_tile, the
# VMEM budget) has no counterpart: the card's geometry is fixed in the source,
# and the wrapper only splits the items into ranges (`_splits`) so that query
# tiles x ranges fill whole waves of the card's resident blocks.
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
MODES = {"float32": 0, "bfloat16": 1, "int8": 2}  # csrc/topk.cu MODE_*
# columns at which an int8 row's int32 sum of 127 * 127 products cannot overflow
INT8_D_MAX = (2**31 - 1) // (127 * 127)
QUANT_ROWS = 1 << 20  # rows converted at a time by narrow_rows
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


def _splits(nq: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """(n_splits, items per split, a whole number of item tiles). The fewest
    ranges for which query tiles x ranges is a whole number of waves of the
    card's resident blocks, unless that takes more than MAX_WAVES waves (then
    enough ranges for MAX_WAVES), each range at least MIN_SPLIT_ITEMS items;
    `_pin_splits` pins the count in place of the rule. One block is resident
    per SM (its shared memory at k = 200; its 512 threads' registers at every
    k)."""
    n_splits = _pin_splits
    if n_splits is None:
        tiles = -(-nq // Q_TILE)
        n_splits = sms // math.gcd(tiles, sms)
        if tiles * n_splits > MAX_WAVES * sms:
            n_splits = -(-MAX_WAVES * sms // tiles)
        n_splits = max(1, min(n_splits, MAX_SPLITS, n // MIN_SPLIT_ITEMS))
    elif not 1 <= n_splits <= MAX_SPLITS:
        raise ValueError(f"_pin_splits must be 1 to {MAX_SPLITS}, got {n_splits}")
    per = -(-n // n_splits)
    per = -(-per // ITEM_TILE) * ITEM_TILE
    return -(-n // per), per


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
    X's narrow operand (narrow_rows) when the caller holds one."""
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
    fn = _cuda.entry("topk")
    q2 = torch.sum(Q * Q, dim=1)
    if x2 is None:
        x2 = center_norms_sq(X)
    # the mask rides in the norm operand: an invalid item's norm reads -1
    x2m = torch.where(valid, x2, -1.0)
    Qop, Xop, qs, xs = Q, X, q2, x2m  # the scales are read by the int8 form only
    if precision != "float32":
        Xn = narrow_rows(X, precision) if items is None else items
        Qn = narrow_rows(Q, precision)
        if precision == "int8" and Xn.rows.shape[1] > INT8_D_MAX:
            raise ValueError(f"the int8 form takes at most {INT8_D_MAX} columns, got {d}")
        Qop, Xop = Qn.rows, Xn.rows
        if precision == "int8":
            qs, xs = Qn.scales, Xn.scales
    d2_out = torch.empty((nq, k), dtype=torch.float32, device=Q.device)
    id_out = torch.empty((nq, k), dtype=torch.int32, device=Q.device)
    n_splits, per = _splits(nq, n, k, _cuda.sm_count(Q))
    part = scratch = d2_out  # not read with one range
    if n_splits > 1:
        # each range's pool of k keys, and the merge's two rounds of scratch
        half = -(-n_splits // 2)
        part = torch.empty((n_splits, nq, k), dtype=torch.int64, device=Q.device)
        scratch = torch.empty((nq, half + -(-half // 2), k), dtype=torch.int64, device=Q.device)
    _cuda.check(
        fn(Qop.data_ptr(), q2.data_ptr(), nq, Qop.shape[1], Xop.data_ptr(), x2m.data_ptr(), n,
           k, n_splits, per, part.data_ptr(), scratch.data_ptr(), d2_out.data_ptr(),
           id_out.data_ptr(), MODES[precision], qs.data_ptr(), xs.data_ptr(),
           _cuda.stream_of(Q)),
        f"top-k kernel ({precision})",
    )
    setattr(fused_topk, LAUNCH_COUNTERS[precision],
            getattr(fused_topk, LAUNCH_COUNTERS[precision]) + 1)
    return d2_out, id_out


# a launch counter a form
LAUNCH_COUNTERS = {"float32": "launches", "bfloat16": "bf16_launches", "int8": "int8_launches"}
fused_topk.launches = 0
fused_topk.bf16_launches = 0
fused_topk.int8_launches = 0
