"""Reconstruct the 1b / 3b train fields at the competition's scale (port of
the JAX package's `scripts/synthesize_1b3b.py`, with its flags, outputs and
seeds).

    python3 -m st_dadk_tpu_torch.cli.synthesize_1b3b [--families 1b 3b] \\
        [--ref_data data] [--out_root data] [--train_ratio 9] \\
        [--m_features 4096] [--seed 2026] [--device cuda|cpu]

The competition ships only the test sites and the solutions of the large
spatial families (`<ref_data>/<fam>/<fam>_<i>_test.csv`, 100,000 sites for
1b and 50,000 for 3b, and `<fam>-solutions.csv`). For each field:

  1. `fit_field`: mean, std and a Matern(nu=1) correlation (partial sill,
     range, nugget) fitted to binned correlations of random site pairs of
     the solutions column (`utils/covariance.fit_matern1`);
  2. `matern_rff`: m random Fourier features from the Matern spectral
     measure (a Student-t with 2 nu degrees of freedom, scale 1/range);
     `eval_latent`: sqrt(2/m) sum_j cos(omega_j . s + phi_j) at
     n_train = train_ratio * n_test uniform sites and at the test sites,
     on the card (1,000,000 points x 4,096 features for 1b);
     `sample_field`: mean + std (sqrt(s2) latent + sqrt(nugget) eps);
  3. 3b's pair (z_{2i-1}, z_{2i}): a one-factor linear model of
     coregionalization, one spectral draw at the two fields' averaged range
     shared by both and mixed with an independent one to the pair's measured
     correlation rho.

Writes `<out_root>/<fam>/<fam>_<i>.csv` (1b: id_train,x,y,z; 3b:
x,y,z1,z2), `<fam>_<i>_synthsol.csv` (the same field at the test sites:
id,z / id,z1,z2) and `fit_params.json` (the fitted parameters by field);
`cli/score_families.py --synth_data <out_root>` scores fits on them. The
values are float32, written in 9 significant digits (they parse back to the
same float32); coordinates are float64 in their shortest round-trip form.

`--ref_data` defaults to the repository's `data/` tree, where
`cli/score_families.py` reads the competition files; the run exits 2 and
names the path when an input file is missing, and likewise without a card
unless `--device cpu`. The numpy functions are the JAX script's, bit for
bit on the same inputs; `eval_latent` forms the phase from float32
multiply-adds (no TF32 product: the phases reach hundreds of radians) and,
on the CPU, takes the cosine in float64, rounded once (`ops/basis.exp_rn`
gives the reason).
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
from st_dadk_tpu_torch.dataio.kaust import read_columns, write_columns
from st_dadk_tpu_torch.utils.covariance import fit_matern1

REPO = Path(__file__).resolve().parents[2]
# points a chunk of eval_latent (the JAX script's), and at most this many
# (point, feature) elements a chunk on the CPU, whose cosine runs in float64
LATENT_CHUNK = 131072
CPU_CHUNK_ELEMENTS = 1 << 24


def fit_field(coords: np.ndarray, z: np.ndarray, n_bins: int = 24,
              max_h: float = 0.5, n_pairs: int = 200_000,
              seed: int = 0) -> Dict[str, float]:
    """Matern(nu=1) fit to the empirical correlation of random site pairs
    of one spatial field (the binning and fit of
    `synthesize_2b.fit_2a_covariance`)."""
    z = np.asarray(z, np.float64)
    mu, sd = float(z.mean()), float(z.std())
    zn = (z - mu) / sd
    rng = np.random.default_rng(seed)
    n = len(z)
    ii = rng.integers(0, n, n_pairs)
    jj = rng.integers(0, n, n_pairs)
    keep = ii != jj
    ii, jj = ii[keep], jj[keep]
    h = np.linalg.norm(coords[ii] - coords[jj], axis=1)
    prod = zn[ii] * zn[jj]
    s2, a, nugget = fit_matern1(h, prod, n_bins=n_bins, max_h=max_h)
    return dict(mean=mu, std=sd, sigma2=s2, range_=a, nu=1.0, nugget=nugget)


def matern_rff(params: Dict[str, float], m: int, seed: int):
    """(omega (m, 2), phi (m,)) drawn from the Matern spectral measure."""
    rng = np.random.default_rng(seed)
    nu = params["nu"]
    g = rng.standard_normal((m, 2))
    u = rng.chisquare(2.0 * nu, size=(m, 1))
    omega = g / params["range_"] * np.sqrt(2.0 * nu / u)
    phi = rng.uniform(0.0, 2.0 * np.pi, size=m)
    return omega, phi


def eval_latent(coords: np.ndarray, omega: np.ndarray, phi: np.ndarray,
                chunk: int = LATENT_CHUNK, device="cuda") -> np.ndarray:
    """sqrt(2/m) sum_j cos(omega_j . s + phi_j) at every point of `coords`
    (n, 2): a latent of about unit variance, float64 (n,).

    float32, as the JAX script computes it: the phase x w_x + y w_y + phi
    from float32 products and sums, the cosine, the sum over the m features
    and the scale. A chunk of points at a time bounds the (chunk, m)
    temporaries."""
    device = resolve_device(device)
    m = len(phi)
    om = torch.as_tensor(np.asarray(omega, np.float32), device=device)
    om_x, om_y = om[:, 0].contiguous(), om[:, 1].contiguous()
    ph = torch.as_tensor(np.asarray(phi, np.float32), device=device)
    scale = float(np.sqrt(np.float32(2.0 / m)))
    c32 = np.ascontiguousarray(coords, dtype=np.float32)
    rows = chunk if device.type != "cpu" else max(
        1, min(chunk, CPU_CHUNK_ELEMENTS // m))
    out = np.empty(len(c32), np.float64)
    for s in range(0, len(c32), rows):
        c = torch.as_tensor(c32[s:s + rows], device=device)
        proj = c[:, :1] * om_x
        proj.addcmul_(c[:, 1:], om_y)
        proj += ph
        if device.type == "cpu":
            cos = torch.cos(proj.double()).float()
        else:
            cos = proj.cos_()
        lat = cos.sum(dim=1) * scale
        out[s:s + len(c)] = lat.double().cpu().numpy()
    return out


def sample_field(params: Dict[str, float], latent: np.ndarray,
                 seed: int) -> np.ndarray:
    """mean + std (sqrt(sigma2) latent + sqrt(nugget) eps), float64."""
    rng = np.random.default_rng(seed)
    eps = rng.standard_normal(len(latent))
    zn = np.sqrt(params["sigma2"]) * latent \
        + np.sqrt(params["nugget"]) * eps
    return params["mean"] + params["std"] * zn


def _test_csvs(fam_dir: Path, fam: str):
    return sorted(fam_dir.glob(f"{fam}_*_test.csv"),
                  key=lambda p: int(p.stem.split("_")[1]))


def missing_inputs(families: Sequence[str], ref_data: Path):
    """The input paths a run over `families` lacks: a family's solutions
    file, or its test files (named by their pattern)."""
    missing = []
    for fam in families:
        fam_dir = ref_data / fam
        if not (fam_dir / f"{fam}-solutions.csv").is_file():
            missing.append(str(fam_dir / f"{fam}-solutions.csv"))
        if not _test_csvs(fam_dir, fam):
            missing.append(str(fam_dir / f"{fam}_<i>_test.csv"))
    return missing


class _Stages:
    """Seconds by stage of one field."""

    def __init__(self):
        self.seconds, self.t0 = {}, time.perf_counter()

    def done(self, stage):
        t = time.perf_counter()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + t - self.t0
        self.t0 = t

    def line(self):
        return (f"{sum(self.seconds.values()):.1f} s: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in self.seconds.items()))


def synthesize_field(fam: str, i: int, test_csv: Path, sol: Dict,
                     out_dir: Path, args, device) -> Dict:
    """One field (1b) or pair (3b): its files in `out_dir`; returns its
    fit_params.json entry."""
    st = _Stages()
    test = read_columns(test_csv)
    te_xy = np.column_stack([test["x"], test["y"]])
    n_test = len(te_xy)
    n_train = int(args.train_ratio * n_test)
    rng = np.random.default_rng(args.seed + 100 * i)
    tr_xy = rng.uniform(size=(n_train, 2))
    xy = np.vstack([tr_xy, te_xy])
    train = {"x": tr_xy[:, 0], "y": tr_xy[:, 1]}
    ids = np.arange(1, n_test + 1)
    st.done("read")

    if fam.startswith("3"):
        cols = [f"z{2 * (i - 1) + 1}", f"z{2 * (i - 1) + 2}"]
        y = np.column_stack([sol[c] for c in cols])[:n_test]
        p1 = fit_field(te_xy, y[:, 0], seed=args.seed + i)
        p2 = fit_field(te_xy, y[:, 1], seed=args.seed + i + 50)
        zn1 = (y[:, 0] - p1["mean"]) / p1["std"]
        zn2 = (y[:, 1] - p2["mean"]) / p2["std"]
        rho = float(np.corrcoef(zn1, zn2)[0, 1])
        # one-factor LMC: a shared spectral draw at the two fields' common
        # (averaged) range, mixed to the measured rho
        shared = dict(p1, range_=0.5 * (p1["range_"] + p2["range_"]))
        om, ph = matern_rff(shared, args.m_features, args.seed + 7 * i)
        om2, ph2 = matern_rff(shared, args.m_features, args.seed + 7 * i + 3)
        st.done("fit")
        lat_s = eval_latent(xy, om, ph, device=device)
        lat_i = eval_latent(xy, om2, ph2, device=device)
        st.done("latent")
        lat2 = rho * lat_s + np.sqrt(max(1 - rho * rho, 0.0)) * lat_i
        z = {"z1": sample_field(p1, lat_s, args.seed + 11 * i),
             "z2": sample_field(p2, lat2, args.seed + 11 * i + 5)}
        st.done("sample")
        entry = dict(z1=p1, z2=p2, cross_corr=rho, n_train=n_train)
        summary = (f"ranges {p1['range_']:.3f}/{p2['range_']:.3f} "
                   f"rho={rho:.3f}")
    else:
        y = sol[f"z{i}"][:n_test]
        p = fit_field(te_xy, y, seed=args.seed + i)
        om, ph = matern_rff(p, args.m_features, args.seed + 7 * i)
        st.done("fit")
        lat = eval_latent(xy, om, ph, device=device)
        st.done("latent")
        z = {"z": sample_field(p, lat, args.seed + 11 * i)}
        st.done("sample")
        train = {"id_train": np.arange(1, n_train + 1), **train}
        entry = dict(z=p, n_train=n_train)
        summary = (f"range {p['range_']:.3f} s2={p['sigma2']:.3f} "
                   f"nugget={p['nugget']:.3f}")
    write_columns(out_dir / f"{fam}_{i}.csv",
                  {**train, **{k: v[:n_train].astype(np.float32)
                               for k, v in z.items()}})
    write_columns(out_dir / f"{fam}_{i}_synthsol.csv",
                  {"id": ids, **{k: v[n_train:].astype(np.float32)
                                 for k, v in z.items()}})
    st.done("write")
    print(f"[synth] {fam}_{i}: {summary} n_train={n_train} ({st.line()})",
          flush=True)
    return entry


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--families", nargs="+", default=["1b", "3b"])
    ap.add_argument("--ref_data", default=str(REPO / "data"))
    ap.add_argument("--out_root", default=str(REPO / "data"))
    ap.add_argument("--train_ratio", type=float, default=9.0,
                    help="n_train = ratio * n_test (1a/3a ship 9:1)")
    ap.add_argument("--m_features", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--device", default="cuda",
                    help="where eval_latent runs (default the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("synthesize_1b3b: no CUDA device; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 2
    missing = missing_inputs(args.families, Path(args.ref_data))
    if missing:
        print("synthesize_1b3b: missing input files: " + ", ".join(missing),
              file=sys.stderr)
        return 2

    for fam in args.families:
        fam_dir = Path(args.ref_data) / fam
        t0 = time.perf_counter()
        sol = read_columns(fam_dir / f"{fam}-solutions.csv")
        print(f"[synth] {fam}: read {fam}-solutions.csv "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        out_dir = Path(args.out_root) / fam
        out_dir.mkdir(parents=True, exist_ok=True)
        all_params = {}
        for test_csv in _test_csvs(fam_dir, fam):
            i = int(test_csv.stem.split("_")[1])
            all_params[f"{fam}_{i}"] = synthesize_field(
                fam, i, test_csv, sol, out_dir, args, device)
        with open(out_dir / "fit_params.json", "w") as f:
            json.dump(all_params, f, indent=2)
        print(f"[synth] wrote {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
