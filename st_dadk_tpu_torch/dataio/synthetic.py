"""Stand-in for the 2a_8 field when `data/2a/2a_8.csv` is absent.

A separable Gaussian random field with the covariance fitted on the real
2a_8 (`data/2b/fit_params.json`: Matern nu=1 in space plus a nugget, AR(1)
in time), at S = 1000 sites drawn uniformly on [0, 1]^2 from a numpy seed,
for T = 100 times: the shape of 2a_8. `synthesize` is the numpy copy of
`scripts/synthesize_2b.py::synthesize`. The CSV goes to `data/standin/`
(listed in `.gitignore`) and is loaded through `dataio.kaust` like the real
file. Its name carries a hash of this module and of the fit parameters,
so a changed generator writes a new field. Scores on the stand-in compare
the port with the JAX package only; the reference's published scores on
2a_8 do not apply to it.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict

import numpy as np

REPO = Path(__file__).resolve().parents[2]
REAL_2A_8 = "data/2a/2a_8.csv"
STANDIN_DIR = "data/standin"
FIT_PARAMS = "data/2b/fit_params.json"


def synthesize(sites: np.ndarray, T: int, params: Dict[str, float],
               seed: int) -> np.ndarray:
    """Separable GRF: AR(1) in time of Cholesky-coloured Matern(nu=1)
    spatial innovations. Returns (T, S) float32 in the original scale."""
    from scipy.special import kv

    S = len(sites)
    d = np.linalg.norm(sites[:, None, :] - sites[None, :, :], axis=-1)
    hh = np.maximum(d, 1e-12) * np.sqrt(2.0) / params["range_"]
    C = params["sigma2"] * hh * kv(1, hh)
    np.fill_diagonal(C, params["sigma2"] + params["nugget"])
    C += 1e-6 * np.eye(S)
    L = np.linalg.cholesky(C)

    rng = np.random.default_rng(seed)
    phi = params["phi_t"]
    z = np.empty((T, S), np.float64)
    z[0] = L @ rng.standard_normal(S)
    scale = np.sqrt(1.0 - phi * phi)
    for t in range(1, T):
        z[t] = phi * z[t - 1] + scale * (L @ rng.standard_normal(S))
    return (params["mean"] + params["std"] * z).astype(np.float32)


def write_standin_csv(path: Path, n_sites: int = 1000, T: int = 100,
                      seed: int = 8) -> Path:
    """Write the stand-in field as x,y,t,z rows (t-major, 2a_8's layout)."""
    with open(REPO / FIT_PARAMS, "r", encoding="utf-8") as f:
        params = json.load(f)
    rng = np.random.default_rng(seed)
    sites = rng.uniform(size=(n_sites, 2)).round(6)
    z = synthesize(sites, T, params, seed=1000 + seed)
    rows = np.column_stack([np.tile(sites[:, 0], T), np.tile(sites[:, 1], T),
                            np.repeat(np.arange(1, T + 1), n_sites),
                            z.ravel()])
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    np.savetxt(tmp, rows, delimiter=",", header="x,y,t,z", comments="",
               fmt=["%.6f", "%.6f", "%d", "%.6f"])
    tmp.replace(path)
    return path


def standin_path() -> Path:
    """`data/standin/2a_8_standin-<hash>.csv`; the hash covers the
    generator's source and `data/2b/fit_params.json`."""
    digest = hashlib.sha256(Path(__file__).read_bytes()
                            + (REPO / FIT_PARAMS).read_bytes()).hexdigest()[:16]
    return REPO / STANDIN_DIR / f"2a_8_standin-{digest}.csv"


def bench_data_file() -> Path:
    """The real 2a_8 when the checkout has it; otherwise the stand-in,
    written on first use."""
    real = REPO / REAL_2A_8
    if real.exists():
        return real
    standin = standin_path()
    if not standin.exists():
        write_standin_csv(standin)
    return standin
