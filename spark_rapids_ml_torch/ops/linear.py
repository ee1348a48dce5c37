#
# Linear regression fit ops of the PyTorch port (counterpart of the JAX package's
# ops/linear.py; reference regression.py:528-606 dispatches among cuML's OLS,
# Ridge and coordinate-descent ElasticNet by regularization).
#
# One pass over X builds the normal-equation sufficient statistics (XᵀWX, XᵀWy);
# everything after is d x d:
#   * no L1  -> direct solve of (XᵀWX/n + λI) w = XᵀWy/n   (OLS: λ = 0; Ridge)
#   * L1 > 0 -> FISTA proximal gradient on the Gram form.
# Objective (Spark parity): 1/(2n)·Σ wᵢ(yᵢ − xᵢ·β − b)² + λ(α‖β‖₁ + (1−α)/2·‖β‖²),
# with `standardization=True` applying the penalty to σ-scaled coefficients.
#
# Routing: unit-weight f32 input takes the fused normal-equation kernel
# (ops/xtwx.py::normal_eq_prefix_mask: csrc/xtx.cu on the card, its plain
# version on the CPU), at the parity tier's n_split (the two-part bf16 split
# under parity_precision="high"); weighted or f64 input takes
# linreg_sufficient_stats, library products, full f32.
#
# FISTA runs on the host loop: reading the stopping quantity `delta` costs one
# scalar device-to-host sync per iteration, which keeps the JAX package's rule
# (it < max_iter and delta > tol) and so its n_iter.
#
# loss="huber" is not ported (it needs the L-BFGS of ops/logistic.py).
#

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils import span
from ._precision import parity_n_split, pdot
from .linalg import power_iteration_lmax
from .xtwx import normal_eq_prefix_mask


def linreg_sufficient_stats(
    X: torch.Tensor, y: torch.Tensor, w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass: (XᵀWX, XᵀWy, x̄, ȳ, Σw)."""
    wsum = torch.sum(w)
    xbar = pdot(w, X) / wsum
    ybar = torch.sum(w * y) / wsum
    Xw = X * w[:, None]
    return pdot(Xw.T, X), pdot(Xw.T, y), xbar, ybar, wsum


def _center_stats(A, b, xbar, ybar, n, fit_intercept: bool):
    """Raw moments to moments centered about the weighted mean."""
    if fit_intercept:
        A = A - n * torch.outer(xbar, xbar)
        b = b - n * xbar * ybar
    return A, b


def _intercept(xbar, ybar, coef, fit_intercept: bool) -> torch.Tensor:
    if fit_intercept:
        return ybar - torch.dot(xbar, coef)
    return torch.zeros((), dtype=coef.dtype, device=coef.device)


def solve_l2(A, b, xbar, ybar, n, scale, reg: float, fit_intercept: bool):
    """Closed-form OLS/Ridge in (optionally σ-scaled) space; returns (coef,
    intercept) in the original feature space."""
    Ac, bc = _center_stats(A, b, xbar, ybar, n, fit_intercept)
    As = Ac / torch.outer(scale, scale)
    bs = bc / scale
    d = As.shape[0]
    lhs = As / n + reg * torch.eye(d, dtype=As.dtype, device=As.device)
    coef = torch.linalg.solve(lhs, bs / n) / scale
    return coef, _intercept(xbar, ybar, coef, fit_intercept)


def solve_elastic_net(
    A, b, xbar, ybar, n, scale, reg: float, l1_ratio: float, fit_intercept: bool,
    max_iter: int, tol: float,
):
    """FISTA on f(β) = 1/(2n)·βᵀAβ − bᵀβ/n (+ L2) with the prox of λ·α‖β‖₁.
    Returns (coef, intercept, n_iter) in the original feature space."""
    Ac, bc = _center_stats(A, b, xbar, ybar, n, fit_intercept)
    As = (Ac / torch.outer(scale, scale)) / n
    bs = (bc / scale) / n
    l1 = reg * l1_ratio
    l2 = reg * (1.0 - l1_ratio)
    # Lipschitz constant of ∇f: λ_max(As) + l2, from a few power iterations
    step = 1.0 / (power_iteration_lmax(As) + l2 + 1e-12)

    def soft(x, t):
        return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)

    wk = torch.zeros((As.shape[0],), dtype=As.dtype, device=As.device)
    zk = wk
    tk = torch.tensor(1.0, dtype=As.dtype, device=As.device)
    tol_t = torch.tensor(tol, dtype=As.dtype, device=As.device)  # in the stats' dtype, as the JAX loop
    n_iter = 0
    while n_iter < max_iter:
        grad = pdot(As, zk) - bs + l2 * zk
        w_next = soft(zk - step * grad, step * l1)
        t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        zk = w_next + ((tk - 1.0) / t_next) * (w_next - wk)
        delta = torch.max(torch.abs(w_next - wk)) / (torch.max(torch.abs(w_next)) + 1e-12)
        wk, tk = w_next, t_next
        n_iter += 1
        if not bool(delta > tol_t):  # the per-iteration sync
            break
    coef = wk / scale
    return coef, _intercept(xbar, ybar, coef, fit_intercept), n_iter


def linreg_fit(
    X: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    reg: float,
    l1_ratio: float,
    fit_intercept: bool,
    standardize: bool,
    max_iter: int,
    tol: float,
    extra_param_sets: Optional[List[Dict[str, Any]]] = None,
    unit_weight: bool = False,
) -> List[Dict[str, Any]]:
    """One statistics pass, then one solve per param set (see solve_from_stats).
    Returns one attribute dict per model."""
    with span("normal_equations"):
        if unit_weight and X.dtype == torch.float32:
            A, b, xbar, ybar, n, _yty = normal_eq_prefix_mask(
                X, y, X.shape[0], parity_n_split()
            )
        else:
            A, b, xbar, ybar, n = linreg_sufficient_stats(X, y, w)
    with span("solve"):  # and the attributes' copies to the host
        return solve_from_stats(
            A, b, xbar, ybar, n,
            reg=reg, l1_ratio=l1_ratio, fit_intercept=fit_intercept,
            standardize=standardize, max_iter=max_iter, tol=tol,
            extra_param_sets=extra_param_sets,
        )


def solve_from_stats(
    A, b, xbar, ybar, n,
    reg: float,
    l1_ratio: float,
    fit_intercept: bool,
    standardize: bool,
    max_iter: int,
    tol: float,
    extra_param_sets: Optional[List[Dict[str, Any]]] = None,
) -> List[Dict[str, Any]]:
    """Solve per param set from sufficient statistics. Each set of
    `extra_param_sets` (backend names: alpha, l1_ratio, fit_intercept, max_iter,
    tol) reuses the same statistics; None solves the one set given. The column
    std for standardization comes from diag(A): var = (ΣwX² − n·x̄²)/(n − 1)."""
    if standardize:
        # unbiased column std, Spark's Summarizer convention
        var = (torch.diagonal(A) - n * xbar * xbar) / torch.clamp(n - 1.0, min=1.0)
        scale = torch.sqrt(torch.clamp(var, min=0.0))
        scale = torch.where(scale <= 0.0, torch.ones_like(scale), scale)
    else:
        scale = torch.ones_like(xbar)

    param_sets = extra_param_sets if extra_param_sets is not None else [
        {"alpha": reg, "l1_ratio": l1_ratio, "fit_intercept": fit_intercept,
         "max_iter": max_iter, "tol": tol}
    ]
    results = []
    for p in param_sets:
        p_reg = float(p.get("alpha", reg))
        p_l1r = float(p.get("l1_ratio", l1_ratio))
        p_fi = bool(p.get("fit_intercept", fit_intercept))
        if p_reg == 0.0 or p_l1r == 0.0:
            coef, intercept = solve_l2(A, b, xbar, ybar, n, scale, p_reg, p_fi)
            n_iter = 1
        else:
            coef, intercept, n_iter = solve_elastic_net(
                A, b, xbar, ybar, n, scale, p_reg, p_l1r, p_fi,
                int(p.get("max_iter", max_iter)), float(p.get("tol", tol)),
            )
        results.append({
            "coefficients": coef.cpu().numpy(),
            "intercept": float(intercept),
            "n_iter": int(n_iter),
        })
    return results


def linreg_predict(X: torch.Tensor, coef: torch.Tensor, intercept: float) -> torch.Tensor:
    return pdot(X, coef) + intercept
