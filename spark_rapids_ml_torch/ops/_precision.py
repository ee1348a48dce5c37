#
# Matmul precision policy of the PyTorch port (counterpart of the JAX package's
# ops/_precision.py).
#
# The JAX package runs every product that feeds a model attribute at its
# `parity_precision`: "highest" by default (full f32, emulated on the TPU by six
# bf16 passes) or "high" (three bf16 passes, about 2^-17 relative error a
# product). The port's plain library products (`pdot`) are full f32 at either
# tier, as XLA's are off the TPU. PyTorch would run f32 convolutions (and, where
# enabled, matmuls) in TF32, which keeps about three decimal digits, so this
# module turns TF32 off for both when it is imported:
#
#     torch.backends.cuda.matmul.allow_tf32 = False
#     torch.backends.cudnn.allow_tf32 = False
#
# The hand-written kernels (csrc/) take the split that the TPU kernels take
# (`_dot_multipass`, spark_rapids_ml_tpu/ops/pallas_kmeans.py), by `n_split`:
#   3  full f32: f32 FMA on the CUDA cores, or 3xTF32 on the tensor cores
#      (csrc/tf32x3.cuh); the six bf16 passes are not emulated;
#   2  "high": each f32 operand split into two bf16 parts, hi and lo, and
#      hi·hi + hi·lo + lo·hi summed in f32 (the Lloyd, assignment and Gram
#      kernels, under parity_precision="high");
#   1  one bf16 pass: both operands rounded to bf16, the products summed in f32
#      (the Lloyd kernel under `fast_math`, the MXU's DEFAULT precision).
# `split_bf16` and `dot_multipass` are the same functions in plain PyTorch.
# `fast_math` is read by KMeans alone (ops/kmeans.py), as in the JAX package.
#

from __future__ import annotations

from typing import List

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = 3  # the n_split of the full-f32 forms
N_SPLIT = {"highest": F32, "high": 2}


def parity_precision() -> str:
    """The precision of model-attribute products, from the config key
    `parity_precision`: "highest" (full f32) or "high" (the two-part bf16
    split in the kernels)."""
    from .. import config as _config

    value = str(_config.get("parity_precision")).lower()
    if value not in N_SPLIT:
        raise ValueError(
            f"parity_precision must be 'highest' or 'high', got '{value}'."
        )
    return value


def parity_n_split() -> int:
    """The kernels' n_split at the configured parity precision: 3 or 2."""
    return N_SPLIT[parity_precision()]


def split_bf16(x: torch.Tensor, n_split: int) -> List[torch.Tensor]:
    """x ≈ Σ parts: n_split bf16 values (held in f32), each the residual so far
    rounded to bf16 to nearest even (counterpart of `_split_bf16`)."""
    parts = []
    r = x
    for i in range(n_split):
        p = r.to(torch.bfloat16).to(torch.float32)
        parts.append(p)
        if i + 1 < n_split:
            r = r - p
    return parts


def multipass(pa, pb, mm):
    """Σ of mm(pa[i], pb[j]) over the pairs of parts with i + j < len(pa),
    smallest first (the loop of `_dot_multipass`)."""
    n = len(pa)
    acc = None
    for i in range(n - 1, -1, -1):
        for j in range(n - 1 - i, -1, -1):
            t = mm(pa[i], pb[j])
            acc = t if acc is None else acc + t
    return acc


def dot_multipass(a: torch.Tensor, b: torch.Tensor, n_split: int) -> torch.Tensor:
    """a @ b as the kernels compute it at n_split (see the header): at 3 a full
    f32 product, at 1 or 2 the sum of the products of the bf16 parts (i, j) with
    i + j < n_split, smallest first (counterpart of `_dot_multipass`). TF32 is
    off, so each product of two bf16 parts is exact and the sums are f32."""
    if n_split < 1:
        raise ValueError(f"n_split must be at least 1, got {n_split}")
    if n_split >= F32:
        return torch.matmul(a, b)
    return multipass(split_bf16(a, n_split), split_bf16(b, n_split), torch.matmul)


def pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Parity-precision library matmul: a full-f32 torch.matmul (TF32 is off),
    at either parity tier."""
    return torch.matmul(a, b)
