#
# KMeans fit/predict ops of the PyTorch port (counterpart of the JAX package's
# ops/kmeans.py; reference clustering.py:376-456 runs cuML's KMeansMG).
#
# Lloyd iterations run through the fused Lloyd kernel (ops/lloyd.py), its
# unit-weight form when there are no sample weights and its weighted form
# otherwise; assignment (transform, the training summary's cluster sizes and the
# k-means|| candidate weighting) runs through the fused assignment kernel
# (ops/select.py). The JAX package's TPU gates (SRML_TPU_PALLAS_KMEANS, k >= 128)
# do not apply here. Empty clusters keep their previous center.
#
# Precision, as the JAX package's fused path picks it (its ops/kmeans.py
# kmeans_fit): the Lloyd step runs at n_split 1 under `fast_math`, else at the
# parity tier's (2 under parity_precision="high", else the f32 form); the
# assignment at the parity tier's, `fast_math` or not. The oversampling
# distances and the reported inertia are library products, full f32.
#
# Initialization: "random" picks k real rows; "k-means||" runs `initSteps`
# rounds of distance-weighted oversampling, 2k rows per round by the Gumbel-top-k
# trick on log(d²) (sampling without replacement ∝ d²), then weighted k-means++
# on the small candidate set on the host (_weighted_kmeans_pp, copied from the
# JAX package as it is). The Gumbel noise comes from a torch.Generator on X's
# device, seeded from `seed`; its numbers differ from jax.random's.
#
# distanceMeasure="cosine" is not ported yet and raises NotImplementedError.
#

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import config as _config
from ..utils import span
from ._precision import parity_n_split
from .lloyd import lloyd_fit
from .select import assign, sq_dists


def _check_metric(metric: str) -> None:
    if metric != "euclidean":
        raise NotImplementedError(
            f"distanceMeasure={metric!r} is not ported to the PyTorch backend yet; "
            "only 'euclidean' runs"
        )


def kmeans_predict(X: torch.Tensor, centers: torch.Tensor, metric: str = "euclidean") -> torch.Tensor:
    """Nearest-center assignment (int32), through the fused assignment kernel
    at the parity tier's n_split."""
    _check_metric(metric)
    return assign(X, centers, parity_n_split())


def kmeans_inertia(X: torch.Tensor, w: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Σ w·min_c max(|x|² − 2·x·c + |c|², 0) in full f32 (parity precision)."""
    return torch.sum(w * torch.min(sq_dists(X, centers), dim=1).values)


def _gumbel(n: int, gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    e = torch.empty((n,), dtype=like.dtype, device=like.device).exponential_(generator=gen)
    return -torch.log(e)


def _random_real_rows(
    X: torch.Tensor, w: torch.Tensor, n_pick: int, gen: torch.Generator
) -> torch.Tensor:
    """Pick n_pick distinct real (w>0) rows via Gumbel-top-k on the mask."""
    g = _gumbel(X.shape[0], gen, X)
    score = torch.where(w > 0, g, torch.full_like(g, -float("inf")))
    return X[torch.topk(score, n_pick).indices]


def _oversample_rounds(
    X: torch.Tensor, w: torch.Tensor, first: torch.Tensor, gen: torch.Generator,
    l: int, steps: int,
) -> torch.Tensor:
    """All k-means|| oversampling rounds: (1 + steps·l, d) candidates. The
    min-distance vector updates against only each round's new candidates;
    already-chosen rows get d²=0 so they are ~never re-drawn."""
    buf = [first[None, :]]
    d2 = sq_dists(X, first[None, :])[:, 0]
    for _ in range(steps):
        logits = torch.where(w > 0, torch.log(d2 + 1e-30), torch.full_like(d2, -float("inf")))
        newc = X[torch.topk(logits + _gumbel(X.shape[0], gen, X), l).indices]
        buf.append(newc)
        d2 = torch.minimum(d2, torch.min(sq_dists(X, newc), dim=1).values)
    return torch.cat(buf, dim=0)


def _cand_sq_dists(candidates: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """(n_cand, k) squared distances via the matmul expansion — never materializes
    the (n_cand, k, d) broadcast (IVF builds call this with k in the thousands)."""
    c2 = np.sum(centers * centers, axis=1)
    x2 = np.sum(candidates * candidates, axis=1)
    return np.maximum(
        x2[:, None] - 2.0 * (candidates @ centers.T) + c2[None, :], 0.0
    )


def _weighted_kmeans_pp_once(
    candidates: np.ndarray, weights: np.ndarray, k: int, rng: np.random.Generator
):
    n = candidates.shape[0]
    centers = np.empty((k, candidates.shape[1]), dtype=candidates.dtype)
    p = weights / weights.sum()
    centers[0] = candidates[rng.choice(n, p=p)]
    d2 = np.sum((candidates - centers[0]) ** 2, axis=1)
    # greedy k-means++ (sklearn-style): draw several d²-weighted trials per step
    # and keep the one that minimizes the resulting potential — a single
    # non-greedy draw can seed two centers in one heavy cluster and the local
    # refinement below cannot always escape that basin
    n_local_trials = 2 + int(np.log(k))
    for i in range(1, k):
        probs = weights * d2
        s = probs.sum()
        if s <= 0:
            centers[i] = candidates[rng.integers(n)]
            d2 = np.minimum(
                d2, np.sum((candidates - centers[i]) ** 2, axis=1)
            )
            continue
        trial_ids = rng.choice(n, size=n_local_trials, p=probs / s)
        trial_d2 = _cand_sq_dists(candidates, candidates[trial_ids])  # (n, t)
        new_d2 = np.minimum(d2[:, None], trial_d2)
        potentials = (weights[:, None] * new_d2).sum(axis=0)
        best_t = int(np.argmin(potentials))
        centers[i] = candidates[trial_ids[best_t]]
        d2 = new_d2[:, best_t]

    # local weighted Lloyd refinement over the (tiny) candidate set — Spark's
    # LocalKMeans runs the same after its ++ seeding; empty centers reseed at the
    # worst-covered candidate
    for _ in range(10):
        d2_all = _cand_sq_dists(candidates, centers)  # (n_cand, k)
        a = np.argmin(d2_all, axis=1)
        sums = np.zeros_like(centers)
        np.add.at(sums, a, candidates * weights[:, None])
        cnts = np.zeros(k, dtype=weights.dtype)
        np.add.at(cnts, a, weights)
        for j in np.nonzero(cnts <= 0)[0]:
            far = np.argmax(np.min(d2_all, axis=1))
            centers[j] = candidates[far]
            d2_all[far] = 0.0
        ok = cnts > 0
        centers[ok] = sums[ok] / cnts[ok, None]
    # score the FINAL centers (the in-loop d2_all predates the last update)
    cost = float(
        np.sum(weights * np.min(_cand_sq_dists(candidates, centers), axis=1))
    )
    return centers, cost


def _weighted_kmeans_pp(
    candidates: np.ndarray,
    weights: np.ndarray,
    k: int,
    rng: np.random.Generator,
    restarts: int = 8,
) -> np.ndarray:
    """Host-side weighted k-means++ over the small candidate set (the final reduce
    of scalable k-means++). Even the greedy ++ draw can land a poor basin the
    refinement cannot escape; restarts scored by weighted candidate inertia make
    that mode vanishingly unlikely at negligible cost (the candidate set is
    ~(1 + steps·2k) rows). Large k (IVF coarse quantizers call this with
    k=nlist in the thousands, candidates ~4k) caps restarts at 2: the greedy
    trials already remove most of the need for restarts, and the per-restart
    cost there is O(k²·t·d) host work."""
    if k > 64:
        restarts = min(restarts, 2)
    best = None
    best_cost = np.inf
    for _ in range(max(restarts, 1)):
        centers, cost = _weighted_kmeans_pp_once(candidates, weights, k, rng)
        # `best is None` guard: NaN costs (NaN features in the candidate set)
        # compare false against everything and must not leave best unset
        if best is None or cost < best_cost:
            best, best_cost = centers, cost
    return best


def kmeans_init(
    X: torch.Tensor, w: torch.Tensor, k: int, init: str, init_steps: int, seed: int
) -> np.ndarray:
    """Initial centers (host array).

    init == "random": k distinct real rows.
    init == "k-means||" (or "scalable-k-means++"): Gumbel-top-k oversampling rounds,
    then weighted k-means++ on the ~(1 + steps·2k) candidates."""
    gen = torch.Generator(device=X.device)
    gen.manual_seed(seed & 0x7FFFFFFF)
    if init == "random":
        with span("init.random"):
            return _random_real_rows(X, w, k, gen).cpu().numpy()

    rng = np.random.default_rng(seed & 0x7FFFFFFF)
    with span("init.oversample"):
        n_real = int(torch.sum(w > 0))
        l = max(2, min(2 * k, n_real))  # never oversample past the real rows
        first = _random_real_rows(X, w, 1, gen)[0]
        candidates = _oversample_rounds(X, w, first, gen, l, max(init_steps, 1))
    with span("init.weighting"):
        # weight candidates by how many points they attract (one assignment pass)
        labels = kmeans_predict(X, candidates).cpu().numpy()
        cand = candidates.cpu().numpy()
        weights = np.bincount(labels, weights=w.cpu().numpy(), minlength=cand.shape[0]).astype(
            cand.dtype
        )
        weights = np.maximum(weights, 1e-12)
    with span("init.kmeans_pp"):
        return _weighted_kmeans_pp(cand, weights, k, rng)


def kmeans_fit(
    X: torch.Tensor,
    w: torch.Tensor,
    k: int,
    max_iter: int,
    tol: float,
    init: str,
    init_steps: int,
    seed: int,
    metric: str = "euclidean",
    unit_weight: bool = False,
) -> Dict[str, object]:
    _check_metric(metric)
    init_centers = torch.as_tensor(
        kmeans_init(X, w, k, init, init_steps, seed), device=X.device
    )
    # The port always takes the fused kernel, the counterpart of the JAX
    # package's lloyd_fit_pallas, and so its n_split. The TPU gates that kernel
    # at k >= 128 (LLOYD_FUSED_MIN_K); below the gate the JAX package's XLA
    # lloyd_fit runs on the TPU, whose update stays at parity precision under
    # fast_math. The port does not copy the gate.
    n_split = 1 if bool(_config.get("fast_math")) else parity_n_split()
    centers, inertia, n_iter = lloyd_fit(
        X, w, init_centers.contiguous(), float(tol), int(max_iter), unit_weight, n_split
    )
    return {
        "cluster_centers": centers.cpu().numpy(),
        "inertia": float(inertia),
        "n_iter": int(n_iter),
    }
