#
# Fused Gram accumulation for the PCA covariance: S2 = XᵀX and s1 = colsum X over
# the rows below n_valid, in one read of X (counterpart of the JAX package's
# ops/pallas_xtwx.py::xtx_pallas / covariance_prefix_mask); and the same pass
# with a label column, which adds Xᵀy, Σy and Σy² for LinearRegression's normal
# equations (counterpart of xtxy_pallas / normal_eq_prefix_mask).
#
# `xtx` and `xtxy` launch the CUDA kernels of csrc/xtx.cu for tensors on the
# card, and run `xtx_plain` / `xtxy_plain`, the same functions in plain PyTorch,
# for tensors on the CPU. The kernels take their products in 3xTF32 on the
# tensor cores, at f32 accuracy; their design and bound on the H100 are in the
# source's header.
#
# Under parity_precision="high" the callers pass n_split 2 (ops/_precision.py):
# every product is the two-part bf16 split, hi·hi + hi·lo + lo·hi. The kernel
# takes its statistics as the Gram of [X | y | 1], so the column sums, Σy and
# Σy² come out of the split products too: Σ(x_hi + x_lo) where the TPU kernel
# sums x in f32, within 2^-16 |x| a row of it.
#

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _cuda
from ._precision import F32, multipass, pdot, split_bf16

TILE = 128  # csrc/xtx.cu: S2 tile edge
ROWS_STEP = 32  # csrc/xtx.cu RSTEP: rows per ring stage
ROWS_PER_FLUSH = 1024  # csrc/xtx.cu: rows per inner accumulator flush
# csrc/xtx.cu SMEM_BYTES: a 4-stage ring of two 32 x (128 + 8) stripes and
# 72 outer sums per thread of 256; one block per SM
SMEM_BYTES = 4 * (4 * 2 * ROWS_STEP * (TILE + 8) + 72 * 256)


def _valid_rows(X: torch.Tensor, n_valid: int) -> torch.Tensor:
    """X with rows at or past n_valid replaced by zeros (a select, not a multiply)."""
    rows = torch.arange(X.shape[0], device=X.device)[:, None]
    return torch.where(rows < n_valid, X, torch.zeros((), dtype=X.dtype, device=X.device))


def _split_stats(Xm: torch.Tensor, ym, n_split: int):
    """(S2, s1) and with a label (Xᵀy, Σy, Σy²) at n_split < 3, as the kernel
    forms them: entries of the Gram of [X | y | 1] by the split products, the
    ones column's lo part 0. X is split once."""
    def mm(a, b):
        return a.T @ b

    px = split_bf16(Xm, n_split)
    ones = split_bf16(torch.ones((Xm.shape[0], 1), dtype=Xm.dtype, device=Xm.device), n_split)
    s2, s1 = multipass(px, px, mm), multipass(px, ones, mm)[:, 0]
    if ym is None:
        return s2, s1
    py = split_bf16(ym[:, None], n_split)
    return (s2, s1, multipass(px, py, mm)[:, 0], multipass(py, ones, mm)[0, 0],
            multipass(py, py, mm)[0, 0])


def _check_n_split(n_split: int) -> None:
    if n_split not in COUNTERS:
        raise ValueError(f"the Gram kernels take n_split 2 or 3, got {n_split}")


# the launch counter of each form: n_split -> attribute of xtx and of xtxy
COUNTERS = {F32: "launches", 2: "launches_high"}


def xtx_plain(X: torch.Tensor, n_valid: int, n_split: int = F32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (XᵀX, colsum X) over rows < n_valid."""
    Xm = _valid_rows(X, n_valid)
    if n_split < F32:
        return _split_stats(Xm, None, n_split)
    return pdot(Xm.T, Xm), Xm.sum(0)


def _chunks(n_valid: int, n_pairs: int, sms: int) -> Tuple[int, int]:
    """(rows per chunk, chunks): tiles x chunks a whole number of waves of the
    card's resident blocks (one per SM), each chunk at least one inner flush
    of rows, a whole number of ring stages."""
    whole = sms // math.gcd(n_pairs, sms)
    most = max(1, n_valid // ROWS_PER_FLUSH)
    n_chunks = min(most, whole)
    rows = -(-max(n_valid, 1) // n_chunks)
    rows = -(-rows // ROWS_STEP) * ROWS_STEP
    return rows, -(-max(n_valid, 1) // rows)


def _check_n_valid(n_valid: int, n: int) -> None:
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} must lie in [0, {n}]")


def _launch(X: torch.Tensor, y, n_valid: int, n_split: int):
    """Launch csrc/xtx.cu on the card: srml_xtx when y is None, else
    srml_xtxy. Returns (S2, s1) or (S2, s1, Xᵀy, Σy, Σy²)."""
    n, d = X.shape
    t = -(-d // TILE)
    rows, n_chunks = _chunks(n_valid, t * (t + 1) // 2, _cuda.sm_count(X))

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=X.device)

    s2_part, s1_part, s2, s1 = new(n_chunks, d, d), new(n_chunks, d), new(d, d), new(d)
    ptrs = (s2_part.data_ptr(), s1_part.data_ptr())
    if y is None:
        _cuda.check(
            _cuda.entry("xtx")(X.data_ptr(), n_valid, d, rows, n_chunks, *ptrs,
                               s2.data_ptr(), s1.data_ptr(), n_split, _cuda.stream_of(X)),
            "xtx kernel",
        )
        return s2, s1
    xty_part, ys_part, xty, ys = new(n_chunks, d), new(n_chunks, 2), new(d), new(2)
    _cuda.check(
        _cuda.entry("xtxy")(X.data_ptr(), y.data_ptr(), n_valid, d, rows, n_chunks, *ptrs,
                            xty_part.data_ptr(), ys_part.data_ptr(), s2.data_ptr(),
                            s1.data_ptr(), xty.data_ptr(), ys.data_ptr(), n_split,
                            _cuda.stream_of(X)),
        "xtxy kernel",
    )
    return s2, s1, xty, ys[0], ys[1]


def xtx(X: torch.Tensor, n_valid: int, n_split: int = F32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S2 (d, d), s1 (d,)) over the first n_valid rows of X (n, d) f32, the
    products at n_split (2 or 3)."""
    n, d = X.shape
    _cuda.require(X, "X", (n, d))
    _check_n_valid(n_valid, n)
    _check_n_split(n_split)
    if _cuda.device_kind(X) == "cpu":
        return xtx_plain(X, n_valid, n_split)
    out = _launch(X, None, n_valid, n_split)
    _cuda.count_launch(xtx, COUNTERS[n_split])
    return out


xtx.launches = 0  # f32 (3xTF32) form
xtx.launches_high = 0  # n_split 2


def covariance_prefix_mask(X: torch.Tensor, n_valid: int, n_split: int = F32):
    """(cov, mean, wsum) of the first n_valid rows, with the unbiased (Σw − 1)
    denominator, from one Gram pass: cov = (S2 − Σw·x̄x̄ᵀ)/(Σw − 1)."""
    s2, s1 = xtx(X, n_valid, n_split)
    wsum = torch.tensor(float(n_valid), dtype=X.dtype, device=X.device)
    mean = s1 / wsum
    cov = (s2 - wsum * torch.outer(mean, mean)) / (wsum - 1.0)
    return cov, mean, wsum


def xtxy_plain(X: torch.Tensor, y: torch.Tensor, n_valid: int, n_split: int = F32):
    """Plain PyTorch version of the label kernel: (XᵀX, colsum X, Xᵀy, Σy, Σy²)
    over rows < n_valid."""
    Xm = _valid_rows(X, n_valid)
    ym = _valid_rows(y[:, None], n_valid)[:, 0]
    if n_split < F32:
        return _split_stats(Xm, ym, n_split)
    return pdot(Xm.T, Xm), Xm.sum(0), pdot(Xm.T, ym), ym.sum(), torch.dot(ym, ym)


def xtxy(X: torch.Tensor, y: torch.Tensor, n_valid: int, n_split: int = F32):
    """(S2 (d, d), s1 (d,), Xᵀy (d,), Σy, Σy²) over the first n_valid rows of
    X (n, d) f32 and y (n,) f32, in one read of X, the products at n_split."""
    n, d = X.shape
    _cuda.require(X, "X", (n, d))
    _cuda.require(y, "y", (n,))
    _check_n_valid(n_valid, n)
    _check_n_split(n_split)
    if _cuda.device_kind(X, y) == "cpu":
        return xtxy_plain(X, y, n_valid, n_split)
    out = _launch(X, y, n_valid, n_split)
    _cuda.count_launch(xtxy, COUNTERS[n_split])
    return out


xtxy.launches = 0  # f32 (3xTF32) form
xtxy.launches_high = 0  # n_split 2


def normal_eq_prefix_mask(X: torch.Tensor, y: torch.Tensor, n_valid: int, n_split: int = F32):
    """Unit-weight normal-equation statistics of the first n_valid rows from one
    pass: (A = XᵀX, b = Xᵀy, x̄, ȳ, Σw, yᵀy), the tuple of the JAX package's
    normal_eq_prefix_mask on one device."""
    s2, s1, xty, ysum, yty = xtxy(X, y, n_valid, n_split)
    wsum = torch.tensor(float(n_valid), dtype=X.dtype, device=X.device)
    return s2, xty, s1 / wsum, ysum / wsum, wsum, yty
