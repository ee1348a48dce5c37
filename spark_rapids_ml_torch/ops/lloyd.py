#
# Fused Lloyd step (counterpart of the JAX package's ops/pallas_kmeans.py
# lloyd_step_pallas_masked / lloyd_step_pallas) and the loop around it
# (counterpart of lloyd_fit_pallas).
#
# One step assigns every row below n_valid to argmin over k of |c|² − 2·x·c
# (first index wins a tie) and returns, per center, the weighted sum of its rows
# and their weight (the count), and the inertia Σ w·max(|x|² + min, 0). Without
# weights (`w=None`) every row below n_valid weighs 1, the unit-weight form; with
# weights n_valid is n, the weighted form.
#
# Each form takes an `n_split` (ops/_precision.py): 3 full f32 (the parity
# default), 2 the two-part bf16 split (parity_precision="high"), 1 one bf16 pass
# (`fast_math`). As in the TPU kernel, both products take the split: the cross
# term x·c and the update onehotᵀ·x, whose one-hot carries the row's weight (so
# the update adds split(w)·split(x), and split(x) for unit weights); the counts,
# |x|² and |c|² stay unrounded f32, and the inertia takes the split cross term.
#
# `lloyd_step` launches the CUDA kernel csrc/lloyd.cu for tensors on the card and
# runs `lloyd_step_plain`, the same function in plain PyTorch, for tensors on the
# CPU. The kernel's design and its bound on the H100 are in the source's header
# and in csrc/nearest.cuh; `_plan` picks its launch.
#

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import span
from . import _cuda
from ._precision import F32, dot_multipass
from .select import nearest_plan


def lloyd_step_plain(
    X: torch.Tensor, centers: torch.Tensor, n_valid: int, w: Optional[torch.Tensor] = None,
    n_split: int = F32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (sums (k, d), counts (k,), inertia)."""
    n = X.shape[0]
    k = centers.shape[0]
    valid = torch.arange(n, device=X.device) < n_valid
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    Xm = torch.where(valid[:, None], X, zero)
    wv = valid.to(X.dtype) if w is None else torch.where(valid, w, zero)
    c2 = torch.sum(centers * centers, dim=1)
    part = c2[None, :] - 2.0 * dot_multipass(Xm, centers.T, n_split)
    assign = torch.argmin(part, dim=1)  # first index of a tie
    min_part = torch.gather(part, 1, assign[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype) * wv[:, None]
    sums = dot_multipass(onehot.T, Xm, n_split)
    counts = torch.sum(onehot, dim=0)
    x2 = torch.sum(Xm * Xm, dim=1)
    inertia = torch.sum(wv * torch.clamp(x2 + min_part, min=0.0))
    return sums, counts, inertia


def _plan(n_valid: int, k: int, d: int, n_split: int = F32, sms: int = 132) -> dict:
    """The Lloyd kernel's launch (csrc/lloyd.cu srml_lloyd_step):
    ops/select.py::nearest_plan for the n_valid rows, the block's sums in
    registers with one chunk of 24 centers and whole rows of at most 256
    columns (the main path), else in shared memory where they fit. With whole
    rows in a stage the update reads them there, and X is read from device
    memory once; past about d = 512 at k = 20 (f32) the rows come in column
    chunks and the update reads them again (x_reads 2)."""
    return nearest_plan(n_valid, k, d, n_split, True, sms)


# the launch counter of each form: (weighted, n_split) -> attribute of lloyd_step
COUNTERS = {
    (False, F32): "launches", (False, 2): "launches_high", (False, 1): "launches_bf16",
    (True, F32): "weighted_launches", (True, 2): "weighted_launches_high",
    (True, 1): "weighted_launches_bf16",
}


def lloyd_step(
    X: torch.Tensor, centers: torch.Tensor, n_valid: int, w: Optional[torch.Tensor] = None,
    n_split: int = F32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused Lloyd pass over X (n, d) f32 against centers (k, d) f32 with
    products at n_split (1, 2 or 3): (sums (k, d), counts (k,), inertia 0-d)."""
    n, d = X.shape
    k = centers.shape[0]
    _cuda.require(X, "X", (n, d))
    _cuda.require(centers, "centers", (k, d))
    if k < 1:
        raise ValueError("a Lloyd step needs at least one center")
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid={n_valid} must lie in [0, {n}]")
    if n_split not in (1, 2, F32):
        raise ValueError(f"the Lloyd kernel takes n_split 1, 2 or 3, got {n_split}")
    tensors = (X, centers)
    if w is not None:
        _cuda.require(w, "w", (n,))
        if n_valid != n:
            raise ValueError("the weighted form takes n_valid = n")
        tensors += (w,)
    if _cuda.device_kind(*tensors) == "cpu":
        return lloyd_step_plain(X, centers, n_valid, w, n_split)
    g = _plan(n_valid, k, d, n_split, _cuda.sm_count(X))
    fn = _cuda.entry("lloyd")
    c2 = torch.sum(centers * centers, dim=1)
    stride = k * d + k + 1
    part = torch.empty((g["blocks"], stride), dtype=torch.float32, device=X.device)
    out = torch.empty((stride,), dtype=torch.float32, device=X.device)
    _cuda.check(
        fn(X.data_ptr(), None if w is None else w.data_ptr(), n_valid, d,
           centers.data_ptr(), c2.data_ptr(), k, g["R"], g["S"], g["DC"],
           int(g["resident"]), g["CK"], int(g["sums_smem"]), g["rows_per_block"],
           g["blocks"], g["smem"], part.data_ptr(), out.data_ptr(), n_split,
           _cuda.stream_of(X)),
        "lloyd kernel",
    )
    _cuda.count_launch(lloyd_step, COUNTERS[(w is not None, n_split)])
    return out[: k * d].view(k, d), out[k * d : k * d + k], out[k * d + k]


for _attr in COUNTERS.values():
    setattr(lloyd_step, _attr, 0)


def lloyd_fit(
    X: torch.Tensor,
    w: torch.Tensor,
    init_centers: torch.Tensor,
    tol: float,
    max_iter: int,
    unit_weight: bool,
    n_split: int = F32,
) -> Tuple[torch.Tensor, float, int]:
    """Lloyd iterations until the largest center movement² <= tol² or max_iter
    (the rule of lloyd_fit_pallas), each step's products at n_split. Returns
    (centers, inertia, n_iter), the inertia recomputed against the final
    centers in full f32, whatever n_split the steps took.

    The loop runs on the host: reading `movement² > tol²` costs one scalar
    device-to-host sync per iteration, which keeps the rule exact."""
    from .kmeans import kmeans_inertia

    n = X.shape[0]
    centers = init_centers
    tol2 = torch.tensor(tol, dtype=X.dtype, device=X.device) ** 2  # in X's dtype, as the JAX loop
    n_iter = 0
    moving = True
    with span("lloyd_loop"):
        while n_iter < max_iter and moving:
            sums, counts, _ = lloyd_step(X, centers, n, None if unit_weight else w, n_split)
            new_centers = torch.where(
                counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], centers
            )
            shift2 = torch.max(torch.sum((new_centers - centers) ** 2, dim=1))
            centers = new_centers
            n_iter += 1
            moving = bool(shift2 > tol2)  # the per-iteration sync
    with span("inertia"):
        inertia = float(kmeans_inertia(X, w, centers))
    return centers, inertia, n_iter
