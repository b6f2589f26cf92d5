"""Data-adaptive basis-center initialisation (port of
`st_dadk_tpu/ops/init_centers.py`: 'gmm', 'kmeans_balanced', 'random_site').

GMM path:

Spherical-covariance EM with exact sequential k-means++ seeding, n_init=3
restarts and sklearn's tol stop (|delta mean log-likelihood| < 1e-3), the
best final log-likelihood kept; bandwidth = 4.23 * 2.5 * sigma clipped below
at 0.25x the uniform-grid bandwidth. Training coords are subsampled to 10k
points from the caller's numpy stream, like the reference. The seeding draws
from a `torch.Generator`, so the seeds differ from the JAX package's; a test
feeds the JAX seeds in through `seeds=`.

`init_spatial_centers_batch` is the init of a whole batch of lanes (the JAX
`init_spatial_centers_batch` / `_batched_gmm_multi`), and
`init_spatial_centers` is that batch of one lane: every lane draws its own
subsample and its own k-means++ seeds from its own streams, and then one EM
a resolution runs all lanes x restarts together (`_em`): the (runs, n, k)
elementwise work is one op for all runs, each sum is taken a run at a time,
a run that has converged stops changing, and a mask of the runs still going
stays on the device, read by the host every `EM_CHECK_EVERY` iterations
instead of one log-likelihood an iteration a run. Lanes share an EM batch
only where their subsamples have one size, so no run's sums see padding and
a lane's centers and bandwidths are bit for bit those of the lane alone.

'kmeans_balanced' (`balanced_kmeans`, `_bkm`): Lloyd steps whose
assignment is a log-domain Sinkhorn transport plan between the points
(mass 1/n each) and the clusters (capacity 1/k each), 50 steps of 40
Sinkhorn iterations, centers the plan-weighted means, the best of three
k-means++-seeded restarts by final transport cost (the first of equals),
bandwidths 2.5x the mean distance to the 4 nearest centers
(`_nn_bandwidths`). Its Sinkhorn iterations are plain PyTorch operations on
(runs, n, k) tensors: the JAX package leaves them to XLA too. All lanes x
restarts of one subsample size run as one batch, every reduction arranged
so that a run sums alike whatever shares its batch: a lane's centers are
bit for bit those of the lane alone.
'random_site' draws k training sites a resolution from the lane's numpy
stream with the JAX package's call pattern. 'kmeans_exact' is the exact
size-constrained k-means of `ops/kmeans_exact.py` (Lloyd steps on the
native transport solver), on the host, lane by lane: each lane subsamples
from its own numpy stream in float64, as the JAX package replays a lane's
stream, and solves each resolution with `kmeans_constrained`.

Two JAX knobs change the GMM and balanced k-means inits:
`seed_rounds` (config `init_seed_rounds`) swaps the exact sequential
k-means++ seeding for the R-round draw `kmeans_plus_plus_rounds`;
`em_dtype='bfloat16'` (config `init_em_dtype`) stores the GMM EM's (n, k)
tensors, the distances and the responsibilities, in bf16, with the
distances formed in float32 first and every sum taken in float32.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from st_dadk_tpu_torch.ops.basis import (uniform_bandwidth_for,
                                         uniform_grid_centers)
from st_dadk_tpu_torch.ops.kmeans_exact import kmeans_constrained

MAX_INIT_SAMPLES = 10_000
# the init methods that consume training coordinates
DATA_ADAPTIVE_INIT_METHODS = ("gmm", "random_site", "kmeans_balanced",
                              "kmeans_exact")
def _choice(p: torch.Tensor, generator: torch.Generator,
            size: int = 1) -> torch.Tensor:
    """`size` indices drawn with replacement by inverse CDF, as
    jax.random.choice(p=...) draws: an all-zero p (every point already a
    seed, e.g. fewer distinct training sites than centers) picks index 0
    instead of failing. One index is a 0-dim tensor."""
    cum = torch.cumsum(p, dim=0)
    u = torch.rand((size,), generator=generator, device=p.device,
                   dtype=p.dtype)
    idx = torch.clamp(torch.searchsorted(cum, cum[-1:] * (1.0 - u)),
                      max=p.shape[0] - 1)
    return idx[0] if size == 1 else idx


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


def kmeans_plus_plus_rounds(X: torch.Tensor, k: int,
                            generator: torch.Generator,
                            rounds: int = 8) -> torch.Tensor:
    """Low-depth k-means++ (JAX init_centers.py:111-168): the first seed,
    then the k - 1 others in `rounds` batches of near-equal size, each drawn
    i.i.d. from the current d2-weighted distribution (k-means||-style), d2
    updated once a round. Draws within a round do not see each other, so
    seeds may repeat; the EM or Lloyd steps absorb that. With k - 1 rounds
    it makes the exact seeding's draws."""
    n = X.shape[0]
    rounds = max(1, min(int(rounds), max(k - 1, 1)))
    ones = torch.ones(n, dtype=X.dtype, device=X.device)
    first = X[_choice(ones / n, generator)]
    d2 = torch.sum((X - first) ** 2, dim=1)
    base, rem = divmod(k - 1, rounds)
    parts = [first[None]]
    for r in range(rounds):
        b = base + (1 if r < rem else 0)
        if b == 0:
            continue
        p = d2 / torch.clamp(d2.sum(), min=1e-12)
        cand = X[_choice(p, generator, b)].reshape(b, -1)
        cand_d2 = torch.sum((X[:, None, :] - cand[None]) ** 2, dim=-1)
        d2 = torch.minimum(d2, torch.min(cand_d2, dim=1).values)
        parts.append(cand)
    return torch.cat(parts, dim=0)


def _seed_centers(X: torch.Tensor, k: int, generator: torch.Generator,
                  seed_rounds: Optional[int] = None) -> torch.Tensor:
    """The exact sequential k-means++ seeding, or with `seed_rounds` the
    R-round draw (JAX `_seed_centers`, init_centers.py:170-177)."""
    if seed_rounds is None:
        return kmeans_plus_plus(X, k, generator)
    return kmeans_plus_plus_rounds(X, k, generator, int(seed_rounds))


EM_CHECK_EVERY = 4             # iterations between host reads of the run mask
EM_BATCH_ELEMENTS = 2 ** 27    # floats of one (lanes, restarts, n, k) tensor


def _em(X: torch.Tensor, means: torch.Tensor, max_iter: int = 100,
        reg_covar: float = 1e-6, tol: float = 1e-3,
        em_dtype: Optional[str] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tol-stopped spherical EM for L lanes x I restarts at once: X
    (L, n, 2) each lane's points, means (L, I, k, 2) seeds -> (means
    (L, I, k, 2), sigmas (L, I, k), final mean log-likelihood (L, I),
    iterations (L, I)). A single init is L = 1.

    The (runs, n, k) elementwise work of an iteration (distances, log
    probabilities, exp, responsibilities) is one op for all runs. Each sum
    over points or components is taken a run at a time on that run's (n, k)
    slice: a batched reduction sums in another order, and the EM, 40 to 90
    tol-stopped iterations with the best of three restarts kept, turns that
    last-bit difference into other iteration counts and other optima (seen
    on an H100: centers 0.8 apart). So a run's arithmetic does not depend
    on which runs share its batch. Every iteration updates all runs and
    keeps the update only where the run is still going (`torch.where` on a
    device mask); a run stops after the update whose |ll - ll_prev| < tol,
    as the JAX while_loop tests the change after the M-step it just took.
    The mask is read on the host every EM_CHECK_EVERY iterations.

    `em_dtype='bfloat16'` stores the distances and the responsibilities in
    bf16 where the JAX EM does (init_centers.py:230-243, :360-366): the
    distances are formed in float32 and rounded once; the E-step reads
    them in float32; the masses, the means and the variances sum in
    float32, the variance's products taken in bf16 as there."""
    # any other value keeps float32, as in JAX (init_centers.py:230)
    big = torch.bfloat16 if em_dtype == "bfloat16" else torch.float32
    L, n, d = X.shape
    I, k = means.shape[1], means.shape[2]
    R = L * I                                              # runs, lane-major
    lane_of = [r // I for r in range(R)]
    Xr = X[:, None].expand(L, I, n, d).reshape(R, n, d)
    means = means.reshape(R, k, d)
    var0 = torch.stack([torch.var(x, unbiased=False) for x in X])
    var = (var0[:, None, None] * torch.ones((L, I, k), dtype=X.dtype,
                                            device=X.device)
           + reg_covar).reshape(R, k)
    weights = torch.full((R, k), 1.0 / k, dtype=X.dtype, device=X.device)

    def per_run(fn, *ts):
        """`fn` on each run's slice of `ts`, stacked: the reductions."""
        return torch.stack([fn(*[t[r] for t in ts]) for r in range(R)])

    def pairwise_d2(m):                                    # -> (R, n, k)
        diff = Xr[:, :, None, :] - m[:, None, :, :]
        return torch.sum(diff * diff, dim=-1).to(big)

    def estep(d2, var, weights):
        log_w = torch.log(torch.clamp(weights, min=1e-30))
        log_prob = (-0.5 * (d2.float() / var[:, None]
                            + d * torch.log(2 * math.pi * var)[:, None])
                    + log_w[:, None])
        m = torch.max(log_prob, dim=-1, keepdim=True).values
        p = torch.exp(log_prob - m)
        s = per_run(lambda pr: torch.sum(pr, dim=1, keepdim=True), p)
        log_norm = m[..., 0] + torch.log(s[..., 0])        # (R, n)
        return (p / s).to(big), per_run(torch.mean, log_norm)

    d2 = pairwise_d2(means)
    going = torch.ones((R,), dtype=torch.bool, device=X.device)
    iters = torch.zeros((R,), dtype=torch.int32, device=X.device)
    ll_prev = torch.full((R,), -math.inf, dtype=torch.float64,
                         device=X.device)
    for it in range(max_iter):
        resp, ll = estep(d2, var, weights)
        nk = per_run(lambda rr: rr.sum(dim=0, dtype=torch.float32),
                     resp) + 1e-10                                # (R, k)
        means_new = torch.stack([resp[r].float().T @ X[lane_of[r]]
                                 for r in range(R)]) / nk[..., None]
        d2_new = pairwise_d2(means_new)
        var_new = torch.clamp(
            per_run(lambda t: t.sum(dim=0, dtype=torch.float32),
                    resp * d2_new) / (nk * d),
            min=0.0) + reg_covar
        g2, g3 = going[:, None], going[:, None, None]
        means = torch.where(g3, means_new, means)
        d2 = torch.where(g3, d2_new, d2)
        var = torch.where(g2, var_new, var)
        weights = torch.where(g2, nk / n, weights)
        iters += going.to(torch.int32)
        ll64 = ll.to(torch.float64)
        stop_now = torch.abs(ll64 - ll_prev) < tol
        ll_prev = torch.where(going, ll64, ll_prev)
        going = going & ~stop_now
        if (it + 1) % EM_CHECK_EVERY == 0 and not bool(going.any()):
            break
    _, ll_final = estep(d2, var, weights)
    return (means.reshape(L, I, k, d), torch.sqrt(var).reshape(L, I, k),
            ll_final.reshape(L, I), iters.reshape(L, I))


def gmm_spherical(X: torch.Tensor, k: int,
                  generator: Optional[torch.Generator] = None,
                  max_iter: int = 100, n_init: int = 3,
                  reg_covar: float = 1e-6, tol: float = 1e-3,
                  seeds: Optional[Sequence[torch.Tensor]] = None,
                  em_dtype: Optional[str] = None,
                  seed_rounds: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit a spherical GMM to X (n, 2): (means (k, 2), sigmas (k,)).

    `n_init` k-means++-seeded restarts (or one EM per given seed in
    `seeds`), the best final log-likelihood kept (the first of equals).
    `em_dtype` and `seed_rounds`: see `_em` and `_seed_centers`."""
    if seeds is None:
        if generator is None:
            raise ValueError("gmm_spherical needs a generator or seeds")
        seeds = [_seed_centers(X, k, generator, seed_rounds)
                 for _ in range(n_init)]
    means, sigmas, ll, _ = _em(
        X[None], torch.stack([s.to(X) for s in seeds])[None], max_iter,
        reg_covar, tol, em_dtype)
    best = int(torch.argmax(ll[0]))
    return means[0, best], sigmas[0, best]


BKM_BATCH_ELEMENTS = 2 ** 27   # floats of one (runs, n, k) tensor
# points a run's rows are padded to: a (runs, k, n) row then starts 16-byte
# aligned wherever its run sits in the batch, and a row of n / 32 too
BKM_ROW_ALIGN = 128


def _halving_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by halving adds, zero-padded to a power of
    two: elementwise ops only, so the order is the same whatever the other
    dims hold."""
    m = x.shape[-1]
    width = 1 << max(m - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, width - m))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _bkm(X: torch.Tensor, seeds: torch.Tensor, max_iter: int = 50,
         sinkhorn_iters: int = 40, eps_scale: float = 0.02
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Balanced k-means for L lanes x I restarts at once: X (L, n, 2) each
    lane's points, seeds (L, I, k, 2) -> (centers (L, I, k, 2), final
    transport cost (L, I)). JAX `balanced_kmeans`' `fit_once`, a run each:
    every Lloyd step takes d2 once and runs the Sinkhorn iterations on it
    with eps = eps_scale * mean(d2) + 1e-9, then sets the centers to
    P^T X / (column mass + 1e-12); the cost is sum(P * d2) of the final
    centers' plan. Each op serves all runs, and no value is read on the
    host inside the loops.

    A run's arithmetic does not depend on which runs share its batch, so a
    lane in a batch is bit for bit the lane alone: 51 plans, each kept as
    the best of three restarts whose costs may tie to the last bits, turn
    any difference into another restart (seen on an H100: centers 0.8
    apart). Every reduction is over a contiguous last dim of one run's rows
    (over the centers of d2 (runs, n, k), over the points of its transpose
    (runs, k, n)), whose kernel sums a row the same way whatever the number
    of rows; the points are zero-padded to a multiple of BKM_ROW_ALIGN with
    point mass 0 (log mass -inf), so every row starts aligned alike; a
    run's total (eps, cost) ends in `_halving_sum`."""
    L, n, d = X.shape
    I, k = seeds.shape[1], seeds.shape[2]
    R = L * I
    n_pad = -(-n // BKM_ROW_ALIGN) * BKM_ROW_ALIGN
    Xr = torch.nn.functional.pad(X, (0, 0, 0, n_pad - n))[:, None].expand(
        L, I, n_pad, d).reshape(R, n_pad, d)
    XrT = Xr.transpose(1, 2).contiguous()                  # (R, 2, n_pad)
    real = torch.arange(n_pad, device=X.device) < n
    # point mass 1/n, 0 on the padding: its f is -inf and its plan column 0
    log_a = torch.where(real, -math.log(float(n)), -math.inf).to(
        X.dtype)[None, :, None]
    log_b = -math.log(float(k))              # cluster capacity 1/k

    def pairwise(c):                         # (R, n_pad, k), (R, k, n_pad)
        diff = Xr[:, :, None, :] - c[:, None, :, :]
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
        return d2, d2.transpose(1, 2).contiguous()

    def ot_plan(d2, d2T):                    # the plan, transposed: (R, k, n)
        rows = torch.sum(d2, dim=2) * real                 # (R, n_pad)
        total = _halving_sum(torch.sum(rows.view(R, 32, n_pad // 32), dim=2))
        eps = (eps_scale * (total / (n * k)) + 1e-9)[:, None, None]
        f = torch.zeros((R, n_pad, 1), dtype=X.dtype, device=X.device)
        g = torch.zeros((R, k, 1), dtype=X.dtype, device=X.device)
        for _ in range(sinkhorn_iters):
            f = eps * (log_a - torch.logsumexp(
                (g.transpose(1, 2) - d2) / eps, dim=2, keepdim=True))
            g = eps * (log_b - torch.logsumexp(
                (f.transpose(1, 2) - d2T) / eps, dim=2, keepdim=True))
        return torch.exp((f.transpose(1, 2) + g - d2T) / eps)

    centers = seeds.reshape(R, k, d)
    for _ in range(max_iter):
        PT = ot_plan(*pairwise(centers))
        mass = torch.sum(PT, dim=2) + 1e-12                # (R, k), ~1/k
        centers = torch.stack(
            [torch.sum(PT * XrT[:, j:j + 1], dim=2) for j in range(d)],
            dim=-1) / mass[..., None]
    d2, d2T = pairwise(centers)
    cost = _halving_sum(torch.sum(ot_plan(d2, d2T) * d2T, dim=2))
    return centers.reshape(L, I, k, d), cost.reshape(L, I)


def balanced_kmeans(X: torch.Tensor, k: int,
                    generator: Optional[torch.Generator] = None,
                    n_init: int = 3,
                    seeds: Optional[torch.Tensor] = None,
                    seed_rounds: Optional[int] = None) -> torch.Tensor:
    """Balanced k-means of X (n, 2): centers (k, 2). `n_init`
    k-means++-seeded restarts from `generator` (or one run per seed of
    `seeds` (I, k, 2)); the lowest final transport cost wins, the first of
    equals (jnp.argmin). `seed_rounds`: see `_seed_centers`."""
    if seeds is None:
        if generator is None:
            raise ValueError("balanced_kmeans needs a generator or seeds")
        seeds = torch.stack([_seed_centers(X, k, generator, seed_rounds)
                             for _ in range(n_init)])
    centers, cost = _bkm(X[None], seeds.to(X)[None])
    return centers[0, int(torch.argmin(cost[0]))]


def _nn_bandwidths(centers: np.ndarray, n_neighbors: int = 4,
                   scale: float = 2.5) -> np.ndarray:
    """2.5 x the mean distance to the `n_neighbors` nearest other centers,
    floored at 0.25x the uniform-grid bandwidth for the same k (copy of the
    JAX package's numpy helper: duplicate centers, e.g. fewer distinct
    training sites than clusters, would otherwise give a bandwidth of 0)."""
    k = centers.shape[0]
    if k == 1:
        return np.array([scale], dtype=np.float32)
    diff = centers[:, None, :] - centers[None, :, :]
    dist = np.sqrt((diff ** 2).sum(-1))
    np.fill_diagonal(dist, np.inf)
    nn = min(n_neighbors, k - 1)
    nearest = np.sort(dist, axis=1)[:, :nn]
    bw = (nearest.mean(axis=1) * scale).astype(np.float32)
    floor = 0.25 * scale / max(np.sqrt(k) - 1.0, 1.0)   # 0.25 x uniform bw
    return np.maximum(bw, np.float32(floor))


def _site_bandwidths(centers: np.ndarray, k: int,
                     n_centers: Sequence[int]) -> np.ndarray:
    """`_nn_bandwidths`, but a resolution of one center takes the uniform
    bandwidth of the FIRST resolution (JAX init_centers.py:949-951)."""
    if k == 1:
        return np.array([uniform_bandwidth_for(int(n_centers[0]))],
                        np.float32)
    return _nn_bandwidths(centers)


def kmeans_exact(train_coords: np.ndarray, n_centers: Sequence[int],
                 rng: Optional[np.random.RandomState] = None,
                 subsample: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The exact balanced k-means init of one lane (JAX
    init_centers.py:955-970): the float64 subsample drawn from `rng`, then
    `kmeans_constrained` a resolution (its own RandomState(42) seeding, the
    native transport solver), bandwidths by `_site_bandwidths`."""
    X = np.asarray(_subsample(train_coords, subsample, rng), np.float64)
    centers_list, bw_list = [], []
    for k in n_centers:
        k = int(k)
        centers = kmeans_constrained(X, k)[0].astype(np.float32)
        centers_list.append(centers)
        bw_list.append(_site_bandwidths(centers, k, n_centers))
    return np.concatenate(centers_list, axis=0), np.concatenate(bw_list,
                                                                axis=0)


def random_site(train_coords: np.ndarray, n_centers: Sequence[int],
                rng: Optional[np.random.RandomState] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """k training sites a resolution, drawn from `rng` with the JAX
    package's call pattern (with replacement only when k > n)."""
    rng = rng or np.random.RandomState()
    centers_list, bw_list = [], []
    for k in n_centers:
        k = int(k)
        idx = rng.choice(len(train_coords), k, replace=k > len(train_coords))
        centers = train_coords[idx].astype(np.float32)
        centers_list.append(centers)
        bw_list.append(_site_bandwidths(centers, k, n_centers))
    return np.concatenate(centers_list, axis=0), np.concatenate(bw_list,
                                                                axis=0)


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
                         gmm_n_init: Optional[int] = None,
                         stats: Optional[Dict[str, Any]] = None,
                         seed_rounds: Optional[int] = None,
                         em_dtype: Optional[str] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(centers (sum_k, 2), bandwidths (sum_k,)) float32 numpy.

    'uniform' is the regular grid; 'gmm' and 'kmeans_balanced' fit each
    resolution on `device` (the card unless the caller names the CPU) from
    the training coords (with their temporal duplicates, i.e. density
    weighting); 'random_site' draws training sites from `rng`;
    'kmeans_exact' solves each resolution on the host from a subsample
    drawn from `rng`. This is the batch init of one lane; `stats`,
    `seed_rounds`, `em_dtype`: see `init_spatial_centers_batch`."""
    return init_spatial_centers_batch(
        method, n_centers, [train_coords],
        None if generator is None else [generator],
        None if rng is None else [rng], device, subsample, gmm_n_init,
        stats, seed_rounds, em_dtype)[0]


def init_spatial_centers_batch(method: str, n_centers: Sequence[int],
                               train_coords_list: Sequence[Optional[np.ndarray]],
                               generators: Optional[Sequence[torch.Generator]]
                               = None,
                               rngs: Optional[Sequence[
                                   np.random.RandomState]] = None,
                               device: torch.device | str = "cuda",
                               subsample: Optional[int] = None,
                               gmm_n_init: Optional[int] = None,
                               stats: Optional[Dict[str, Any]] = None,
                               seed_rounds: Optional[int] = None,
                               em_dtype: Optional[str] = None
                               ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The spatial init of M lanes of one resolution list at once: one
    (centers (sum_k, 2), bandwidths (sum_k,)) pair a lane.

    'uniform' returns the grid M times; 'random_site' draws each lane's
    sites from `rngs[i]`; 'kmeans_exact' runs `kmeans_exact` lane by lane
    on the host, each lane's subsample from `rngs[i]` (a lane in a batch is
    the lane alone). 'gmm' and 'kmeans_balanced': lane i subsamples
    from `rngs[i]` and seeds every (resolution, restart) from
    `generators[i]`, resolution by resolution, so its streams do not depend
    on the other lanes; the fits of all lanes x restarts of a resolution
    then run as one batch (`_em`, `_bkm`), and each lane keeps its best
    restart. Only lanes whose subsamples have one size share a batch, in
    chunks that keep a (lanes, restarts, n, k) tensor within
    EM_BATCH_ELEMENTS / BKM_BATCH_ELEMENTS floats; `_em` takes every sum a
    run at a time, so a GMM lane is bit for bit the lane alone. `stats`,
    where given, collects 'seed_seconds', 'em_seconds' (the EM's or the
    Lloyd-Sinkhorn's; the device waited for after each), the
    'best_restart' (M,) each lane kept and, for the GMM, the
    'em_iterations' (M, restarts), a list of one array a resolution.
    `seed_rounds` (JAX `init_seed_rounds`) seeds every restart with
    `kmeans_plus_plus_rounds`; `em_dtype='bfloat16'` (JAX `init_em_dtype`)
    stores the GMM EM's (n, k) tensors in bf16 (`_em`)."""
    M = len(train_coords_list)
    if method == "uniform":
        pair = uniform_grid_centers(n_centers)
        return [pair] * M
    if method not in DATA_ADAPTIVE_INIT_METHODS:
        raise ValueError(f"Unknown init_method: {method}")
    if any(tc is None for tc in train_coords_list):
        raise ValueError(f"train_coords required for {method} initialization")
    if rngs is not None and len(rngs) != M:
        raise ValueError(f"{method} initialization of {M} lanes needs {M} "
                         f"rngs or none")
    if method == "random_site":
        return [random_site(tc, n_centers, None if rngs is None else rngs[i])
                for i, tc in enumerate(train_coords_list)]
    if method == "kmeans_exact":
        t0 = time.perf_counter()
        out = [kmeans_exact(tc, n_centers, None if rngs is None else rngs[i],
                            subsample)
               for i, tc in enumerate(train_coords_list)]
        if stats is not None:
            stats["seed_seconds"] = 0.0
            stats["em_seconds"] = time.perf_counter() - t0
        return out
    if generators is None or len(generators) != M:
        raise ValueError(f"{method} initialization of {M} lanes needs {M} "
                         f"generators (and {M} rngs or none)")
    gmm = method == "gmm"
    dev = torch.device(device)
    timed = stats is not None and dev.type == "cuda"
    ni = 3 if gmm_n_init is None or not gmm else int(gmm_n_init)
    ks = [int(k) for k in n_centers]
    t0 = time.perf_counter()
    Xs = [torch.as_tensor(np.asarray(
        _subsample(tc, subsample, None if rngs is None else rngs[i]),
        np.float32), device=dev) for i, tc in enumerate(train_coords_list)]
    # seeds[i][r]: (restarts, k_r, 2), each lane from its own generator,
    # resolution-major
    seeds = [[torch.stack([_seed_centers(X, k, gen, seed_rounds)
                           for _ in range(ni)])
              for k in ks] for X, gen in zip(Xs, generators)]
    if timed:
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()

    by_size: Dict[int, List[int]] = {}
    for i, x in enumerate(Xs):
        by_size.setdefault(x.shape[0], []).append(i)
    centers = [[None] * len(ks) for _ in range(M)]
    bandwidths = [[None] * len(ks) for _ in range(M)]
    budget = EM_BATCH_ELEMENTS if gmm else BKM_BATCH_ELEMENTS
    for r, k in enumerate(ks):
        iters_r = np.zeros((M, ni), np.int32)
        best_r = np.zeros((M,), np.int64)
        bw_min = 0.25 * uniform_bandwidth_for(k)
        for n, lanes in by_size.items():
            step = max(1, budget // (ni * n * k))
            for a in range(0, len(lanes), step):
                idx = lanes[a:a + step]
                X_b = torch.stack([Xs[i] for i in idx])
                seeds_b = torch.stack([seeds[i][r] for i in idx])
                if gmm:
                    means, sigmas, ll, iters = _em(X_b, seeds_b,
                                                   em_dtype=em_dtype)
                    best = torch.argmax(ll, dim=1)          # (lanes,)
                    iters_r[idx] = iters.cpu().numpy()
                else:
                    means, cost = _bkm(X_b, seeds_b)
                    best = torch.argmin(cost, dim=1)        # first of equals
                pick = torch.arange(len(idx), device=means.device)
                means_np = means[pick, best].cpu().numpy()
                best_r[idx] = best.cpu().numpy()
                if gmm:
                    sig_np = sigmas[pick, best].cpu().numpy()
                for j, i in enumerate(idx):
                    centers[i][r] = means_np[j].astype(np.float32)
                    bandwidths[i][r] = (
                        np.clip(4.23 * 2.5 * sig_np[j], bw_min,
                                np.inf).astype(np.float32) if gmm
                        else _site_bandwidths(centers[i][r], k, n_centers))
        if stats is not None:
            stats.setdefault("best_restart", []).append(best_r)
            if gmm:
                stats.setdefault("em_iterations", []).append(iters_r)
    if stats is not None:
        stats["seed_seconds"] = t1 - t0
        stats["em_seconds"] = time.perf_counter() - t1
    return [(np.concatenate(centers[i], axis=0),
             np.concatenate(bandwidths[i], axis=0)) for i in range(M)]
