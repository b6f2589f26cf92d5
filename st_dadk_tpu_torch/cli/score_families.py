"""Score the model on every KAUST competition family against its ground
truth, `<data_dir>/<fam>/<fam>-solutions.csv` (port of
`scripts/score_families.py`).

    python3 -m st_dadk_tpu_torch.cli.score_families --families 1a 1b 2a 3a 3b \
        [--data_dir data] [--epochs 300] [--seed S] [--holdout 0.1] \
        [--only 2a_8 3a_1.z2] [--synth_data DIR] [--out DIR] [--device cuda]

Modes, chosen a dataset by the files there:

  train     <stem>_train.csv exists: train on it, predict the official test
            rows, score them against the solutions column;
  splitsol  only <stem>_test.csv and the solutions: hold out a seeded share
            of the solution rows, train on the rest, score the held-out rows;
  synth     (with --synth_data) a reconstructed `<fam>_<i>.csv` beside its
            `_synthsol.csv`, scored at the official test rows.

Bivariate families (3a, 3b) fit one model a field; dataset i field j is
solutions column z_{2(i-1)+j}. Every fit is multi-quantile (the 5 levels of
the reference), so each score has CRPS beside RMSE and MAE (the median
quantile). Writes `scores.csv` and `scores.json` into --out. The fits run
on the config's `device` (`tpu` and `gpu` mean the card) unless --device
names another.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from st_dadk_tpu_torch.config import (ExperimentConfig, load_config,
                                      resolve_device)
from st_dadk_tpu_torch.dataio.arrays import PointSet
from st_dadk_tpu_torch.dataio.kaust import read_columns
from st_dadk_tpu_torch.models.st_interp import (from_jax_params, init_model,
                                                model_consts,
                                                spec_from_config)
from st_dadk_tpu_torch.ops.init_centers import (DATA_ADAPTIVE_INIT_METHODS,
                                                init_spatial_centers)
from st_dadk_tpu_torch.ops.losses import compute_crps_multi_quantile
from st_dadk_tpu_torch.sweep.grid import write_records
from st_dadk_tpu_torch.train.loop import fit, predict

QUANTILE_LEVELS = [0.05, 0.25, 0.5, 0.75, 0.95]


def _header(path: Path) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        cols = [c.strip().strip('"') for c in f.readline().split(",")]
    return [c for c in cols if c and not c.startswith("Unnamed")]


def _pointset(coords, t, y) -> PointSet:
    n = len(y)
    return PointSet(coords=np.asarray(coords, np.float32),
                    t=np.asarray(t, np.float32).reshape(n, 1),
                    y=np.asarray(y, np.float32).reshape(n, 1),
                    w=np.ones(n, np.float32), n_real=n)


def fit_and_predict(cfg: ExperimentConfig, seed: int,
                    train_xyt: Tuple[np.ndarray, np.ndarray],
                    train_z: np.ndarray,
                    eval_xyt: Tuple[np.ndarray, np.ndarray],
                    device: torch.device) -> Tuple[np.ndarray, int]:
    """Train one multi-quantile model on (coords, t_norm, z) points and
    return its (n_eval, Q) quantile predictions at the eval points in the
    original scale, and the epochs it ran."""
    mu, sd = float(np.mean(train_z)), float(np.std(train_z))
    sd = sd if sd > 0 else 1.0
    zn = (train_z - mu) / sd

    perm = np.random.default_rng(seed).permutation(len(zn))
    n_tr = int(0.9 * len(zn))
    tr_idx, va_idx = perm[:n_tr], perm[n_tr:]
    coords, t = train_xyt
    train_ps = _pointset(coords[tr_idx], t[tr_idx], zn[tr_idx])
    valid_ps = _pointset(coords[va_idx], t[va_idx], zn[va_idx])

    train_coords = (train_ps.coords
                    if cfg.spatial_init_method in DATA_ADAPTIVE_INIT_METHODS
                    else None)
    centers, bw = init_spatial_centers(
        cfg.spatial_init_method, cfg.k_spatial_centers, train_coords,
        generator=torch.Generator(device=device).manual_seed(seed),
        device=device, rng=np.random.RandomState(seed))
    spec = spec_from_config(cfg)
    model = init_model(torch.Generator().manual_seed(seed), spec, centers,
                       bw, device=device)
    res = fit(cfg, spec, model, train_ps, valid_ps, seed=seed)
    serving = from_jax_params(spec, res.params, model_consts(model),
                              device=device)
    ecoords, et = eval_xyt
    preds = predict(serving, np.asarray(ecoords, np.float32),
                    np.asarray(et, np.float32).reshape(-1, 1))
    return preds * sd + mu, res.n_epochs_run


def score(preds: np.ndarray, y_true: np.ndarray,
          qlevels: Sequence[float]) -> Dict[str, float]:
    med = preds[:, len(qlevels) // 2]
    return {"rmse": float(np.sqrt(np.mean((med - y_true) ** 2))),
            "mae": float(np.mean(np.abs(med - y_true))),
            "crps": compute_crps_multi_quantile(preds, y_true, list(qlevels))}


def iter_jobs(families: Sequence[str], data_dir: Path,
              synth_dir: Optional[Path] = None) -> Iterator[Dict[str, Any]]:
    """A dict (name, fam, mode, field, train_csv, test_csv, sol_path,
    sol_col) a fit: a family's 'synth' jobs first (with `synth_dir`), then
    one job a dataset and field whose solutions column exists."""
    for fam in families:
        fam_dir = data_dir / fam
        if synth_dir is not None:
            sdir = synth_dir / fam
            for train_csv in sorted(sdir.glob(f"{fam}_*.csv")):
                stem = train_csv.stem
                if not stem.split("_")[-1].isdigit():
                    continue
                i = int(stem.split("_")[-1])
                ssol = sdir / f"{fam}_{i}_synthsol.csv"
                test_csv = fam_dir / f"{fam}_{i}_test.csv"
                if not (ssol.exists() and test_csv.exists()):
                    continue
                fields = ("z1", "z2") if fam in ("3a", "3b") else ("z",)
                for f in fields:
                    name = f"{fam}_{i}" + (f".{f}" if len(fields) > 1 else "")
                    yield dict(name=name + "@synth", fam=fam, mode="synth",
                               field=f, train_csv=train_csv,
                               test_csv=test_csv, sol_path=ssol, sol_col=f)
        sol_path = fam_dir / f"{fam}-solutions.csv"
        if not sol_path.exists():
            print(f"[WARN] {fam}: no solutions file; skipping "
                  f"(2b ships no ground truth at all)")
            continue
        sol_cols = [c for c in _header(sol_path) if c != "id"]
        tests = sorted(fam_dir.glob(f"{fam}_*_test.csv"),
                       key=lambda p: int(p.stem.split("_")[1]))
        bivariate = fam in ("3a", "3b")
        for test_csv in tests:
            i = int(test_csv.stem.split("_")[1])
            train_csv = fam_dir / f"{fam}_{i}_train.csv"
            fields = ("z1", "z2") if bivariate else ("z",)
            for j, f in enumerate(fields):
                col = f"z{2 * (i - 1) + j + 1}" if bivariate else f"z{i}"
                if col not in sol_cols:
                    continue
                mode = "train" if train_csv.exists() else "splitsol"
                name = f"{fam}_{i}" + (f".{f}" if bivariate else "")
                yield dict(name=name, fam=fam, mode=mode, field=f,
                           train_csv=train_csv, test_csv=test_csv,
                           sol_path=sol_path, sol_col=col)


def run_job(job: Dict[str, Any], cfg: ExperimentConfig, seed: int,
            holdout: float, device: torch.device
            ) -> Tuple[Dict[str, float], int, int, int]:
    """(metrics, n_train, n_eval, epochs run) of one job."""
    test = read_columns(job["test_csv"])
    y_sol = read_columns(job["sol_path"])[job["sol_col"]]
    has_t = "t" in test
    n_test = len(test["x"])

    def t_norm(tvals, t_max):
        return (np.asarray(tvals, np.float64) - 1.0) / max(t_max - 1.0, 1.0)

    def xy(cols):
        return np.stack([cols["x"], cols["y"]], axis=1)

    if job["mode"] in ("train", "synth"):
        tr = read_columns(job["train_csv"])
        zcol = job["field"] if job["field"] in tr else "z"
        n_train = len(tr["x"])
        t_max = float(max(tr["t"].max(), test["t"].max())) if has_t else 1.0
        train_xyt = (xy(tr), t_norm(tr["t"], t_max) if has_t
                     else np.zeros(n_train))
        eval_xyt = (xy(test), t_norm(test["t"], t_max) if has_t
                    else np.zeros(n_test))
        preds, n_ep = fit_and_predict(cfg, seed, train_xyt, tr[zcol],
                                      eval_xyt, device)
        return score(preds, y_sol, cfg.quantile_levels), n_train, n_test, n_ep

    # splitsol: the solutions field at the official test sites, split
    if n_test != len(y_sol):
        raise ValueError("solutions/test row mismatch")
    pts = xy(test)
    tv = (t_norm(test["t"], float(test["t"].max())) if has_t
          else np.zeros(n_test))
    perm = np.random.default_rng(seed + 777).permutation(len(y_sol))
    n_hold = int(holdout * len(y_sol))
    hold, tr_i = perm[:n_hold], perm[n_hold:]
    preds, n_ep = fit_and_predict(cfg, seed, (pts[tr_i], tv[tr_i]),
                                  y_sol[tr_i], (pts[hold], tv[hold]), device)
    return (score(preds, y_sol[hold], cfg.quantile_levels), len(tr_i),
            n_hold, n_ep)


def family_means(rows: List[Dict[str, Any]]) -> Dict[Tuple[str, str],
                                                     Dict[str, float]]:
    """Mean RMSE / MAE / CRPS by (fam, mode), over the rows that scored."""
    groups: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
    for r in rows:
        if "rmse" in r:
            groups.setdefault((r["fam"], r["mode"]), []).append(r)
    return {key: {m: float(np.mean([r[m] for r in rs]))
                  for m in ("rmse", "mae", "crps")}
            for key, rs in sorted(groups.items())}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", nargs="+",
                    default=["1a", "1b", "2a", "3a", "3b"])
    ap.add_argument("--config", default="configs/config_st_interp.yaml")
    ap.add_argument("--data_dir", default="data")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--seed", type=int, default=2025)
    ap.add_argument("--holdout", type=float, default=0.1)
    ap.add_argument("--only", nargs="*", default=None,
                    help="restrict to dataset names, e.g. 2a_8 3a_1.z2")
    ap.add_argument("--synth_data", default=None,
                    help="data tree with reconstructed 1b/3b files; adds "
                         "mode='synth' jobs")
    ap.add_argument("--out", default="results/family_scores")
    ap.add_argument("--device", default=None,
                    help="default: the config's device")
    return ap


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config).replace(
        epochs=args.epochs, regression_type="multi-quantile",
        quantile_levels=list(QUANTILE_LEVELS), save_plots=False,
        save_artifacts=False)
    device = resolve_device(args.device or cfg.device)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows: List[Dict[str, Any]] = []
    synth_dir = Path(args.synth_data) if args.synth_data else None
    for job in iter_jobs(args.families, Path(args.data_dir), synth_dir):
        if args.only and job["name"] not in args.only \
                and job["name"].split("@")[0] not in args.only:
            # '--only 1b_1' selects the splitsol job and its '@synth' one
            continue
        t0 = time.time()
        try:
            metrics, n_train, n_eval, n_ep = run_job(job, cfg, args.seed,
                                                     args.holdout, device)
        except Exception as e:  # keep scoring the rest
            print(f"[FAILED] {job['name']}: {e}")
            rows.append(dict(name=job["name"], fam=job["fam"],
                             mode=job["mode"], error=str(e)))
            continue
        wall = time.time() - t0
        rows.append(dict(name=job["name"], fam=job["fam"], mode=job["mode"],
                         sol_col=job["sol_col"], n_train=n_train,
                         n_eval=n_eval, epochs_run=n_ep,
                         seconds=round(wall, 1), **metrics))
        print(f"[SCORE] {job['name']:<10} mode={job['mode']:<8} "
              f"RMSE={metrics['rmse']:.4f} MAE={metrics['mae']:.4f} "
              f"CRPS={metrics['crps']:.4f}  ({wall:.0f}s, {n_ep} epochs)")

    write_records(rows, out_dir / "scores.csv")
    with open(out_dir / "scores.json", "w", encoding="utf-8") as f:
        json.dump(rows, f, indent=2)
    print(f"\n[OK] wrote {out_dir}/scores.csv")
    for (fam, mode), m in family_means(rows).items():
        print(f"  {fam:<4} {mode:<8} rmse {m['rmse']:.4f}  "
              f"mae {m['mae']:.4f}  crps {m['crps']:.4f}")
    return rows


if __name__ == "__main__":
    main()
