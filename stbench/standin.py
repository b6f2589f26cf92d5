"""The 2a_8-shaped stand-in field, made from a run's seed.

A frozen copy of `st_dadk_tpu_torch/dataio/synthetic.py` (`synthesize` and
`write_standin_csv`): a separable Gaussian random field, AR(1) in time of
Cholesky-coloured Matern(nu = 1) spatial innovations with the covariance
fitted on the real 2a_8 (the configuration file holds those numbers, copied
from `data/2b/fit_params.json`), at S sites drawn uniformly on [0, 1]^2 for
T times, written as x,y,t,z rows (t-major, 6 decimals: 2a_8's layout). Each
seed gives its own sites and values; every seed gives the same sizes, so the
work of a run does not depend on the seed.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np


def synthesize(sites: np.ndarray, T: int, params: Dict[str, float],
               rng: np.random.Generator) -> np.ndarray:
    """(T, S) float32 in the field's original scale."""
    from scipy.special import kv

    S = len(sites)
    d = np.linalg.norm(sites[:, None, :] - sites[None, :, :], axis=-1)
    hh = np.maximum(d, 1e-12) * np.sqrt(2.0) / params["range_"]
    C = params["sigma2"] * hh * kv(1, hh)
    np.fill_diagonal(C, params["sigma2"] + params["nugget"])
    C += 1e-6 * np.eye(S)
    L = np.linalg.cholesky(C)
    phi = params["phi_t"]
    z = np.empty((T, S), np.float64)
    z[0] = L @ rng.standard_normal(S)
    scale = np.sqrt(1.0 - phi * phi)
    for t in range(1, T):
        z[t] = phi * z[t - 1] + scale * (L @ rng.standard_normal(S))
    return (params["mean"] + params["std"] * z).astype(np.float32)


def make_field(seed: int, n_sites: int, T: int, params: Dict[str, float]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(sites (S, 2) rounded to 6 decimals, z (T, S) float32) of a seed."""
    rng = np.random.default_rng([int(seed), 0x5eed])
    sites = rng.uniform(size=(n_sites, 2)).round(6)
    return sites, synthesize(sites, T, params, rng)


def write_csv(path: Path, sites: np.ndarray, z: np.ndarray) -> Path:
    """x,y,t,z rows, t-major, t from 1."""
    T, S = z.shape
    rows = np.column_stack([np.tile(sites[:, 0], T), np.tile(sites[:, 1], T),
                            np.repeat(np.arange(1, T + 1), S), z.ravel()])
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(path, rows, delimiter=",", header="x,y,t,z", comments="",
               fmt=["%.6f", "%.6f", "%d", "%.6f"])
    return path


def read_csv(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """(z (T, S) float32, coords (S, 2) float32) of such a file, sites in
    their order of first appearance, as the file's reader in the program
    takes them; the values are the file's, parsed to double and rounded
    once to float32."""
    a = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64)
    t = a[:, 2].astype(np.int64)
    T = int(t.max())
    keys = a[:, 0:2]
    _, first, inv = np.unique(keys, axis=0, return_index=True,
                              return_inverse=True)
    order = np.argsort(first)                  # unique rows by first use
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    site = rank[inv.ravel()]
    S = len(order)
    z = np.full((T, S), np.nan, np.float32)
    z[t - 1, site] = a[:, 3].astype(np.float32)
    coords = keys[first[order]].astype(np.float32)
    return z, coords
