"""Data-adaptive basis-center initialisation, GMM path (port of the 'gmm'
branch of `st_dadk_tpu/ops/init_centers.py`).

Spherical-covariance EM with exact sequential k-means++ seeding, n_init=3
restarts and sklearn's tol stop (|delta mean log-likelihood| < 1e-3), the
best final log-likelihood kept; bandwidth = 4.23 * 2.5 * sigma clipped below
at 0.25x the uniform-grid bandwidth. Training coords are subsampled to 10k
points from the caller's numpy stream, like the reference. The seeding draws
from a `torch.Generator`, so the seeds differ from the JAX package's; a test
feeds the JAX seeds in through `seeds=`.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from st_dadk_tpu_torch.ops.basis import (uniform_bandwidth_for,
                                         uniform_grid_centers)

MAX_INIT_SAMPLES = 10_000
DATA_ADAPTIVE_INIT_METHODS = ("gmm",)


def _choice(p: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One index drawn by inverse CDF, as jax.random.choice(p=...) draws:
    an all-zero p (every point already a seed, e.g. fewer distinct training
    sites than centers) picks index 0 instead of failing."""
    cum = torch.cumsum(p, dim=0)
    u = torch.rand((1,), generator=generator, device=p.device, dtype=p.dtype)
    idx = torch.searchsorted(cum, cum[-1:] * (1.0 - u))
    return torch.clamp(idx, max=p.shape[0] - 1)[0]


def kmeans_plus_plus(X: torch.Tensor, k: int,
                     generator: torch.Generator) -> torch.Tensor:
    """Exact sequential k-means++ seeding over X (n, d) -> (k, d)."""
    n = X.shape[0]
    ones = torch.ones(n, dtype=X.dtype, device=X.device)
    centers = [X[_choice(ones / n, generator)]]
    d2 = torch.sum((X - centers[0]) ** 2, dim=1)
    for _ in range(k - 1):
        c = X[_choice(d2 / torch.clamp(d2.sum(), min=1e-12), generator)]
        centers.append(c)
        d2 = torch.minimum(d2, torch.sum((X - c) ** 2, dim=1))
    return torch.stack(centers)


def _em(X: torch.Tensor, means: torch.Tensor, max_iter: int,
        reg_covar: float, tol: float
        ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """One tol-stopped spherical EM run from given means:
    (means, sigmas, final mean log-likelihood)."""
    n, d = X.shape
    k = means.shape[0]
    var = torch.var(X, unbiased=False) * torch.ones(k, dtype=X.dtype,
                                                    device=X.device) + reg_covar
    weights = torch.full((k,), 1.0 / k, dtype=X.dtype, device=X.device)

    def pairwise_d2(m):
        diff = X[:, None, :] - m[None, :, :]
        return torch.sum(diff * diff, dim=-1)

    def estep(d2, var, weights):
        log_w = torch.log(torch.clamp(weights, min=1e-30))
        log_prob = (-0.5 * (d2 / var[None] + d * torch.log(2 * math.pi * var)[None])
                    + log_w[None])
        m = torch.max(log_prob, dim=1, keepdim=True).values
        p = torch.exp(log_prob - m)
        s = torch.sum(p, dim=1, keepdim=True)
        return p / s, torch.mean(m[:, 0] + torch.log(s[:, 0]))

    d2 = pairwise_d2(means)
    ll_prev = -math.inf
    for _ in range(max_iter):
        resp, ll_t = estep(d2, var, weights)
        nk = resp.sum(dim=0) + 1e-10
        means = (resp.T @ X) / nk[:, None]
        d2 = pairwise_d2(means)
        var = torch.clamp((resp * d2).sum(dim=0) / (nk * d), min=0.0) + reg_covar
        weights = nk / n
        # the JAX while_loop tests the change after the M-step it just took
        ll = float(ll_t)
        if abs(ll - ll_prev) < tol:
            break
        ll_prev = ll
    _, ll_final = estep(d2, var, weights)
    return means, torch.sqrt(var), float(ll_final)


def gmm_spherical(X: torch.Tensor, k: int,
                  generator: Optional[torch.Generator] = None,
                  max_iter: int = 100, n_init: int = 3,
                  reg_covar: float = 1e-6, tol: float = 1e-3,
                  seeds: Optional[Sequence[torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit a spherical GMM to X (n, 2): (means (k, 2), sigmas (k,)).

    `n_init` k-means++-seeded restarts (or one EM per given seed in
    `seeds`), the best final log-likelihood kept. The stop follows the JAX
    loop: after each E/M pair, stop once |ll - ll_prev| < tol."""
    if seeds is None:
        if generator is None:
            raise ValueError("gmm_spherical needs a generator or seeds")
        seeds = [kmeans_plus_plus(X, k, generator) for _ in range(n_init)]
    best = None
    for s in seeds:
        means, sigmas, ll = _em(X, s.to(X), max_iter, reg_covar, tol)
        if best is None or ll > best[2]:
            best = (means, sigmas, ll)
    return best[0], best[1]


def _subsample(train_coords: np.ndarray, cap: Optional[int] = None,
               rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Reference-stream subsample to `cap` points (drawn from `rng`)."""
    cap = MAX_INIT_SAMPLES if cap is None else int(cap)
    if len(train_coords) > cap:
        idx = (rng or np.random.RandomState()).choice(len(train_coords), cap,
                                                      replace=False)
        return train_coords[idx]
    return train_coords


def init_spatial_centers(method: str, n_centers: Sequence[int],
                         train_coords: Optional[np.ndarray] = None,
                         generator: Optional[torch.Generator] = None,
                         device: torch.device | str = "cuda",
                         rng: Optional[np.random.RandomState] = None,
                         subsample: Optional[int] = None,
                         gmm_n_init: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(centers (sum_k, 2), bandwidths (sum_k,)) float32 numpy.

    'uniform' is the regular grid; 'gmm' fits each resolution on `device`
    (the card unless the caller names the CPU) from the training coords
    (with their temporal duplicates, i.e. density weighting). Other JAX
    init methods are not ported yet."""
    if method == "uniform":
        return uniform_grid_centers(n_centers)
    if method != "gmm":
        raise NotImplementedError(f"init method {method!r} is not ported yet")
    if train_coords is None:
        raise ValueError("train_coords required for gmm initialization")
    X = torch.as_tensor(np.asarray(_subsample(train_coords, subsample, rng),
                                   np.float32), device=device)
    ni = 3 if gmm_n_init is None else int(gmm_n_init)
    centers_list: List[np.ndarray] = []
    bw_list: List[np.ndarray] = []
    for k in n_centers:
        means, sigmas = gmm_spherical(X, int(k), generator, n_init=ni)
        bw = np.clip(4.23 * 2.5 * sigmas.cpu().numpy(),
                     0.25 * uniform_bandwidth_for(int(k)), np.inf)
        centers_list.append(means.cpu().numpy().astype(np.float32))
        bw_list.append(bw.astype(np.float32))
    return np.concatenate(centers_list, axis=0), np.concatenate(bw_list, axis=0)
