#
# PCA fit/transform ops of the PyTorch port (counterpart of the JAX package's
# ops/pca.py; reference feature.py:228-269 calls PCAMG.fit).
#
# One pass builds the d x d covariance from sufficient statistics, then a
# symmetric eigendecomposition extracts the top-k components.
#
# Routing: unit-weight f32 input takes the fused Gram kernel (ops/xtwx.py), on
# the card and, through its plain version, on the CPU; weighted or f64 input
# takes weighted_covariance (ops/linalg.py). The JAX package's TPU gates (the
# 512-column VMEM cap and the TPU platform check) do not apply here. The Gram
# kernel runs at the parity tier's n_split (the two-part bf16 split under
# parity_precision="high"); weighted_covariance is a library product, full f32.
#
# Parity notes:
#   * component signs canonicalized so each component's max-|.| element is positive
#     (the reference's signFlip / sklearn svd_flip convention).
#   * transform does NOT center: Spark's PCA projects raw rows
#     (reference feature.py:438-451).
#

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ._precision import parity_n_split, pdot
from .linalg import weighted_covariance
from .xtwx import covariance_prefix_mask


def covariance_for_fit(X: torch.Tensor, w: torch.Tensor, unit_weight: bool):
    """(cov, mean, wsum) of X's rows weighted by w, with the unbiased (Σw − 1)
    denominator."""
    if unit_weight and X.dtype == torch.float32:
        return covariance_prefix_mask(X, X.shape[0], parity_n_split())
    return weighted_covariance(X, w)


def _pca_from_cov(cov: torch.Tensor, k: int):
    eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
    vals = torch.flip(eigvals, dims=[0])[:k]  # top-k, descending
    vecs = torch.flip(eigvecs, dims=[1])[:, :k].T  # (k, d)
    # sign canonicalization: max-|.| element of each component positive
    idx = torch.argmax(torch.abs(vecs), dim=1)
    signs = torch.sign(vecs[torch.arange(k, device=vecs.device), idx])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    vecs = vecs * signs[:, None]
    return vals, vecs, torch.trace(cov)


def pca_attrs_from_cov(
    cov: torch.Tensor, mean: torch.Tensor, wsum: torch.Tensor, k: int
) -> Dict[str, np.ndarray]:
    """Host-side model attributes from a covariance."""
    vals, vecs, total_var = _pca_from_cov(cov, k)
    n = float(wsum)
    vals_h = vals.cpu().numpy().astype(np.float64)
    return {
        "mean": mean.cpu().numpy(),
        "components": vecs.cpu().numpy(),
        "explained_variance": vals_h,
        "explained_variance_ratio": vals_h / float(total_var),
        "singular_values": np.sqrt(np.maximum(vals_h, 0.0) * (n - 1.0)),
    }


def pca_transform(X: torch.Tensor, components: torch.Tensor) -> torch.Tensor:
    """Spark-parity projection of raw (uncentered) rows: X @ Vᵀ."""
    return pdot(X, components.T)
