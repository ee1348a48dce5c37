#
# Matmul precision policy of the PyTorch port (counterpart of the JAX package's
# ops/_precision.py).
#
# The JAX package runs every product that feeds a model attribute at its
# `parity_precision`, HIGHEST by default: full f32, emulated on the TPU by bf16
# splitting. The port's counterpart is a plain f32 product. PyTorch would run f32
# convolutions (and, where enabled, matmuls) in TF32, which keeps about three
# decimal digits, so this module turns TF32 off for both when it is imported:
#
#     torch.backends.cuda.matmul.allow_tf32 = False
#     torch.backends.cudnn.allow_tf32 = False
#
# The hand-written kernels (csrc/) compute at f32 accuracy: in f32 FMA on the
# CUDA cores, or (the top-k and Gram kernels) in 3xTF32 on the tensor cores,
# each f32 operand split into two TF32 parts and three products summed in f32
# (csrc/tf32x3.cuh). Only parity_precision="highest" is honored; `fast_math`
# (reduced-precision ranking products) is not implemented yet and raises.
#

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def parity_precision() -> str:
    """The precision of model-attribute products, from the config key
    `parity_precision`. Only "highest" (full f32) exists in the port."""
    from .. import config as _config

    value = str(_config.get("parity_precision")).lower()
    if value != "highest":
        raise NotImplementedError(
            f"parity_precision={value!r}: the PyTorch port computes in full f32 "
            "only ('highest')"
        )
    return value


def check_precision_config() -> None:
    """Raise for a precision request the port cannot honor."""
    from .. import config as _config

    parity_precision()
    if bool(_config.get("fast_math")):
        raise NotImplementedError(
            "fast_math=True is not implemented in the PyTorch port yet; the f32 "
            "kernels honor parity precision only"
        )


def pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Parity-precision matmul: a full-f32 torch.matmul (TF32 is off)."""
    return torch.matmul(a, b)
