"""Forecasting-submission CLI (port of `scripts/forecast_submission.py`).

    python3 -m st_dadk_tpu_torch.cli.forecast_submission --family data/2a/2a_8 \
        [--L 20] [--epochs 300] [--batch_size 4096] [--lr 1e-3] [--seed S] \
        [--out forecast.csv] [--device cuda]

Trains the multi-horizon forecaster (`models/forecaster.py`) on sliding
windows of `<stem>_train.csv` (t = 1..T_tr) at the sites with a complete
history, forecasts the test horizon from the last L steps, maps the
forecasts onto the rows of `<stem>_test.csv` (a site without a complete
history takes the mean of the training field), writes the submission and,
where `<fam>-solutions.csv` is there, prints a `[SCORE]` line with the
persistence baseline (each site's last training value) beside it. The fit
runs on the card unless `--device` names another.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from st_dadk_tpu_torch.cli.predict_submission import (resolve_pair,
                                                      solution_column)
from st_dadk_tpu_torch.config import resolve_device
from st_dadk_tpu_torch.dataio.kaust import (load_kaust_csv, read_columns,
                                            write_z_csv)
from st_dadk_tpu_torch.dataio.windows import (prepare_test_context,
                                              train_valid_window_split)
from st_dadk_tpu_torch.models.forecaster import (ForecastSpec, fit_forecaster,
                                                 init_forecaster,
                                                 predict_forecaster,
                                                 rows_from_windows)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", type=str, required=True,
                    help="dataset stem, e.g. data/2a/2a_8")
    ap.add_argument("--L", type=int, default=20, help="context length")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=2025)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    stem = Path(args.family)
    train_path, test_path = resolve_pair(stem)

    z_train, z_test, coords, site_to_idx, meta = load_kaust_csv(
        train_path, test_path, normalize=True)
    T_tr, S = z_train.shape
    H = z_test.shape[0]
    T_total = T_tr + H
    print(f"[INFO] {train_path.name}: T_tr={T_tr} S={S}; horizon H={H}")

    # sites with a complete history can be forecast directly
    obs_sites = np.where(~np.isnan(z_train).any(axis=0))[0]
    z_filled = np.nan_to_num(z_train, nan=0.0)
    spec = ForecastSpec(L=args.L, H=H)

    train_ds, valid_ds = train_valid_window_split(
        z_filled, coords, obs_sites, spec.L, spec.H, val_ratio=0.2)
    tr_rows = rows_from_windows(train_ds, T_total)
    va_rows = rows_from_windows(valid_ds, T_total)
    print(f"[INFO] windows: {len(train_ds)} train / {len(valid_ds)} valid "
          f"x {len(obs_sites)} sites -> {tr_rows.y_hist.shape[0]} samples")

    model = init_forecaster(torch.Generator().manual_seed(args.seed), spec,
                            device=device)
    t0 = time.time()
    _, hist = fit_forecaster(model, tr_rows, va_rows, epochs=args.epochs,
                             batch_size=args.batch_size, lr=args.lr,
                             seed=args.seed, verbose=True)
    train_seconds = time.time() - t0
    print(f"[INFO] trained in {train_seconds:.1f}s "
          f"({hist['n_epochs_run']} epochs)")

    # forecast from the last-L context (ref prepare_test_context)
    ctx = prepare_test_context(z_filled, coords, obs_sites, spec.L)
    preds = predict_forecaster(
        model, ctx["y_hist_obs"][0, :, :, 0].T, ctx["obs_coords"][0],
        np.full((len(obs_sites), 1), T_tr / max(T_total - 1, 1), np.float32))
    preds = preds * meta["z_std"] + meta["z_mean"]          # (n_obs, H)

    # map forecasts onto the test rows via the site index
    test = read_columns(test_path)
    site_idx = np.array([site_to_idx[(float(a), float(b))]
                         for a, b in zip(test["x"], test["y"])], np.int64)
    obs_pos = {int(s): i for i, s in enumerate(obs_sites)}
    t_idx = test["t"].astype(np.int64) - meta["T_te_start"]
    fallback = float(np.nanmean(z_train) * meta["z_std"] + meta["z_mean"])
    z_hat = np.empty(len(site_idx), np.float64)
    for i, (s, ti) in enumerate(zip(site_idx, t_idx)):
        pos = obs_pos.get(int(s))
        z_hat[i] = preds[pos, ti] if pos is not None else fallback

    out = args.out or f"forecast_submission_{stem.name}.csv"
    write_z_csv(z_hat, out)
    print(f"[INFO] submission -> {out}")
    summary: Dict[str, Any] = {"out": out, "z_hat": z_hat, "hist": hist,
                               "n_obs_sites": len(obs_sites),
                               "n_train_rows": tr_rows.y_hist.shape[0],
                               "n_valid_rows": va_rows.y_hist.shape[0],
                               "train_seconds": train_seconds}

    fam = stem.name.split("_")[0]
    ds_idx = int(stem.name.split("_")[1])
    sol_path = train_path.parent / f"{fam}-solutions.csv"
    if sol_path.exists():
        col = f"z{ds_idx}"
        y_true = solution_column(sol_path, col, len(z_hat))
        if y_true is not None:
            rmse = float(np.sqrt(np.mean((z_hat - y_true) ** 2)))
            mae = float(np.mean(np.abs(z_hat - y_true)))
            # persistence baseline: last observed value per site
            last = z_filled[-1] * meta["z_std"] + meta["z_mean"]
            z_pers = last[site_idx]
            rmse_p = float(np.sqrt(np.mean((z_pers - y_true) ** 2)))
            print(f"[SCORE] vs {sol_path.name}:{col}  RMSE={rmse:.6f}  "
                  f"MAE={mae:.6f}  (persistence RMSE={rmse_p:.6f})")
            summary.update(rmse=rmse, mae=mae, persistence_rmse=rmse_p)
    return summary


if __name__ == "__main__":
    main()
