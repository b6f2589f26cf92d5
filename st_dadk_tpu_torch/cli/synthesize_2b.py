"""Reconstruct the 2b train field for the Table 4.4 protocol (port of the
JAX package's `scripts/synthesize_2b.py`, with its flags, outputs and
seeds).

    python3 -m st_dadk_tpu_torch.cli.synthesize_2b [--indices 8] [--T 100] \\
        [--out_dir data/2b] [--fit_from data/2a/2a_8.csv] \\
        [--sites_from data/2b] [--device cuda|cpu]

The competition ships 2b's test sites without z (`2b_<i>_test.csv`: x, y,
t), while Table 4.4 trains on a full 2b field. This builds a statistical
stand-in:

  1. `fit_2a_covariance`: the covariance of the full 2a_8 field (the same
     generator family): the lag-1 temporal autocorrelation averaged over
     sites, and a Matern(nu=1) correlation (partial sill, range, nugget)
     fitted to binned same-time correlations of random site pairs
     (`utils/covariance.fit_matern1`);
  2. `dataio/synthetic.synthesize`: a separable Gaussian random field with
     those parameters at the test file's sites (those of its first time
     step), for t = 1..T: Cholesky-coloured spatial innovations through an
     AR(1), seed 1000 + i.

Writes `<out_dir>/fit_params.json` and `<out_dir>/2b_<i>.csv` (x,y,t,z,
t-major, floats in %.6f: 2a_8's layout). All of it is numpy on the host, as
in the JAX script, and bit for bit its output on the same inputs; the card
is required as for the port's other tools unless `--device cpu`. The
defaults read the repository's `data/` tree; the run exits 2 and names the
path when an input file is missing.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from st_dadk_tpu_torch.config import resolve_device
from st_dadk_tpu_torch.dataio.kaust import (load_kaust_csv_single,
                                           read_columns, write_columns)
from st_dadk_tpu_torch.dataio.synthetic import synthesize
from st_dadk_tpu_torch.utils.covariance import fit_matern1

REPO = Path(__file__).resolve().parents[2]


def fit_2a_covariance(path_2a: Path, n_bins: int = 24,
                      max_h: float = 0.5) -> Dict[str, float]:
    """(mean, std, phi_t, Matern sigma2 and range with nu = 1, nugget) of a
    complete (x, y, t, z) field."""
    z, coords, _ = load_kaust_csv_single(path_2a, normalize=False,
                                         verbose=False)
    z = np.asarray(z, np.float64)                      # (T, S)
    mu, sd = z.mean(), z.std()
    zn = (z - mu) / sd

    # temporal lag-1 autocorrelation, averaged across sites
    z0, z1 = zn[:-1], zn[1:]
    phi = float(np.mean(np.sum(z0 * z1, 0)
                        / np.sqrt(np.sum(z0 * z0, 0) * np.sum(z1 * z1, 0))))

    # spatial: empirical same-time correlation binned by distance
    rng = np.random.default_rng(0)
    S = coords.shape[0]
    ii = rng.integers(0, S, 200_000)
    jj = rng.integers(0, S, 200_000)
    keep = ii != jj
    ii, jj = ii[keep], jj[keep]
    h = np.linalg.norm(coords[ii] - coords[jj], axis=1)
    prod = np.mean(zn[:, ii] * zn[:, jj], axis=0)      # E[z_i z_j] per pair
    s2, a, nugget = fit_matern1(h, prod, n_bins=n_bins, max_h=max_h)
    return dict(mean=float(mu), std=float(sd), phi_t=phi,
                sigma2=s2, range_=a, nu=1.0, nugget=nugget)


def first_time_sites(test_csv: Path) -> np.ndarray:
    """The (x, y) float64 rows of a test file's first time step."""
    cols = read_columns(test_csv)
    first = cols["t"] == cols["t"].min()
    return np.column_stack([cols["x"][first], cols["y"][first]])


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--indices", type=int, nargs="+", default=[8])
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--out_dir", type=str, default=str(REPO / "data" / "2b"))
    ap.add_argument("--fit_from", type=str,
                    default=str(REPO / "data" / "2a" / "2a_8.csv"))
    ap.add_argument("--sites_from", type=str,
                    default=str(REPO / "data" / "2b"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("synthesize_2b: no CUDA device; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 2
    tests = [Path(args.sites_from) / f"2b_{i}_test.csv" for i in args.indices]
    missing = [str(p) for p in [Path(args.fit_from)] + tests
               if not p.is_file()]
    if missing:
        print("synthesize_2b: missing input files: " + ", ".join(missing),
              file=sys.stderr)
        return 2

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"[synth2b] fitting covariance from {args.fit_from}")
    t0 = time.perf_counter()
    params = fit_2a_covariance(Path(args.fit_from))
    print(f"[synth2b] fitted: {params} (fit "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)
    with open(out_dir / "fit_params.json", "w") as f:
        json.dump(params, f, indent=2)

    for i, test_csv in zip(args.indices, tests):
        t0 = time.perf_counter()
        sites = first_time_sites(test_csv)
        t1 = time.perf_counter()
        print(f"[synth2b] 2b_{i}: {len(sites)} sites x T={args.T}",
              flush=True)
        z = synthesize(sites, args.T, params, seed=1000 + i)
        t2 = time.perf_counter()
        out = out_dir / f"2b_{i}.csv"
        write_columns(out, {"x": np.tile(sites[:, 0], args.T),
                            "y": np.tile(sites[:, 1], args.T),
                            "t": np.repeat(np.arange(1, args.T + 1),
                                           len(sites)),
                            "z": z.ravel()}, float_format="%.6f")
        t3 = time.perf_counter()
        print(f"[synth2b] wrote {out} ({args.T * len(sites)} rows; read "
              f"{t1 - t0:.2f} s, synthesize {t2 - t1:.2f} s, write "
              f"{t3 - t2:.2f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
