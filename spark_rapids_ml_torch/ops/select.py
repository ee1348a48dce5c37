#
# Fused nearest-center assignment (counterpart of the JAX package's
# ops/pallas_select.py::fused_assign): labels = argmin over k of
# max(|x|² − 2·x·c + |c|², 0), the first index winning a tie.
#
# `assign` launches the CUDA kernel csrc/assign.cu for tensors on the card and
# runs `assign_plain`, the same function in plain PyTorch, for tensors on the
# CPU. The kernel's design and its bound on the H100 are in the source's header.
#
# The cross term x·c takes `n_split` (ops/_precision.py): 3 full f32, or 2 the
# two-part bf16 split, which the callers pass under parity_precision="high"
# (ops/kmeans.py::kmeans_predict; `fast_math` leaves the assignment at the
# parity tier, as the JAX package's `_assign_n_split` does). |x|² and |c|² stay
# unrounded f32. `sq_dists` is the library product, full f32 at either tier.
#

from __future__ import annotations

import torch

from . import _cuda
from ._precision import F32, dot_multipass, pdot


def sq_dists(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(n, k) clamped squared euclidean distances, by the matmul expansion."""
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=1)
    return torch.clamp(x2 - 2.0 * pdot(X, centers.T) + c2, min=0.0)


def assign_plain(X: torch.Tensor, centers: torch.Tensor, n_split: int = F32) -> torch.Tensor:
    """Plain PyTorch version of the kernel (torch.argmin returns the first index
    of a tie)."""
    x2 = torch.sum(X * X, dim=1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=1)
    d2 = torch.clamp(x2 - 2.0 * dot_multipass(X, centers.T, n_split) + c2, min=0.0)
    return torch.argmin(d2, dim=1).to(torch.int32)


# the launch counter of each form: n_split -> attribute of assign
COUNTERS = {F32: "launches", 2: "launches_high"}


def assign(X: torch.Tensor, centers: torch.Tensor, n_split: int = F32) -> torch.Tensor:
    """int32 (n,) index of the nearest of centers (k, d) for each row of X (n, d)
    f32, the cross term at n_split (2 or 3)."""
    n, d = X.shape
    k = centers.shape[0]
    _cuda.require(X, "X", (n, d))
    _cuda.require(centers, "centers", (k, d))
    if k < 1:
        raise ValueError("assign needs at least one center")
    if n_split not in COUNTERS:
        raise ValueError(f"the assignment kernel takes n_split 2 or 3, got {n_split}")
    if _cuda.device_kind(X, centers) == "cpu":
        return assign_plain(X, centers, n_split)
    fn = _cuda.entry("assign")
    c2 = torch.sum(centers * centers, dim=1)
    labels = torch.empty((n,), dtype=torch.int32, device=X.device)
    n_blocks = max(1, min(-(-n // _cuda.NR_ROWS), 8 * _cuda.sm_count(X)))
    _cuda.check(
        fn(X.data_ptr(), n, d, centers.data_ptr(), c2.data_ptr(), k,
           labels.data_ptr(), n_blocks, n_split, _cuda.stream_of(X)),
        "assign kernel",
    )
    _cuda.count_launch(assign, COUNTERS[n_split])
    return labels


assign.launches = 0  # f32 form
assign.launches_high = 0  # n_split 2
