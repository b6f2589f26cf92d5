"""Competition-submission CLI (port of `scripts/predict_submission.py`).

    python3 -m st_dadk_tpu_torch.cli.predict_submission --family data/2a/2a_8 \
        [--config configs/config_st_interp.yaml] [--epochs N] [--seed S] \
        [--out submission.csv] [--solution_column K]

Trains the interpolation model on `<stem>_train.csv`, predicts the rows of
`<stem>_test.csv` at their (x, y, t), writes the submission (one column z)
and, where the family's `<fam>-solutions.csv` is there, prints a `[SCORE]`
line against its column `z<K>` (K defaults to the dataset index of the
stem). All observed train points are split 90/10 by `default_rng(seed)`,
time is normalised by T_te_start + T_te - 2, and a multi-quantile fit
submits its median quantile, de-normalised. The fit runs on the config's
`device` (`tpu` and `gpu` mean the card) unless `--device` names another.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from st_dadk_tpu_torch.config import ExperimentConfig, resolve_device
from st_dadk_tpu_torch.dataio.arrays import PointSet
from st_dadk_tpu_torch.dataio.kaust import (load_kaust_csv, read_columns,
                                            write_z_csv)
from st_dadk_tpu_torch.models.st_interp import (from_jax_params, init_model,
                                                model_consts,
                                                spec_from_config)
from st_dadk_tpu_torch.ops.init_centers import (DATA_ADAPTIVE_INIT_METHODS,
                                                init_spatial_centers)
from st_dadk_tpu_torch.train.loop import fit, predict


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--family", type=str, required=True,
                        help="dataset stem, e.g. data/2a/2a_8 (expects "
                             "<stem>_train.csv and <stem>_test.csv)")
    parser.add_argument("--config", type=str,
                        default="configs/config_st_interp.yaml")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=2025)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--solution_column", type=int, default=None,
                        help="column (1-based z<k>) in the family's "
                             "-solutions.csv to score against; default: the "
                             "dataset index from the stem")
    parser.add_argument("--device", type=str, default=None,
                        help="default: the config's device")
    return parser


def resolve_pair(stem: Path) -> tuple:
    """The `<stem>_train.csv` / `<stem>_test.csv` paths, resolved as a
    config's data_file is; SystemExit when either is missing."""
    resolve = lambda p: ExperimentConfig(data_file=str(p)).resolve_data_file()
    train_path = resolve(f"{stem}_train.csv")
    test_path = resolve(f"{stem}_test.csv")
    if not train_path.exists() or not test_path.exists():
        raise SystemExit(f"missing {train_path} / {test_path}")
    return train_path, test_path


def solution_column(sol_path: Path, col: str, n_rows: int
                    ) -> Optional[np.ndarray]:
    """The solutions file's column `col` as float64 when it exists and has
    `n_rows` rows, else None (with the JAX script's warning)."""
    sol = read_columns(sol_path)
    if col in sol and len(sol[col]) == n_rows:
        return sol[col]
    print(f"[WARN] cannot score: column {col} or row count mismatch")
    return None


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    cfg = ExperimentConfig.from_yaml(args.config)
    if args.epochs:
        cfg = cfg.replace(epochs=args.epochs)
    device = resolve_device(args.device or cfg.device)

    stem = Path(args.family)
    train_path, test_path = resolve_pair(stem)
    print(f"[INFO] training on {train_path}")
    z_train, z_test, coords, _, meta = load_kaust_csv(
        train_path, test_path, normalize=True)

    # all observed train points -> train/valid split 90/10 at random
    tt, ss = np.nonzero(~np.isnan(z_train))
    y = z_train[tt, ss]
    denom = max(meta["T_te_start"] + z_test.shape[0] - 2, 1)
    t_norm = (tt / denom).astype(np.float32)
    perm = np.random.default_rng(args.seed).permutation(len(y))
    n_tr = int(0.9 * len(y))

    def ps(idx: np.ndarray) -> PointSet:
        return PointSet(coords=coords[ss[idx]].astype(np.float32),
                        t=t_norm[idx][:, None],
                        y=y[idx].astype(np.float32)[:, None],
                        w=np.ones(len(idx), np.float32), n_real=len(idx))

    train_ps, valid_ps = ps(perm[:n_tr]), ps(perm[n_tr:])
    train_coords = (train_ps.coords
                    if cfg.spatial_init_method in DATA_ADAPTIVE_INIT_METHODS
                    else None)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    centers, bw = init_spatial_centers(
        cfg.spatial_init_method, cfg.k_spatial_centers, train_coords,
        generator=gen, device=device,
        rng=np.random.RandomState(args.seed))
    spec = spec_from_config(cfg)
    model = init_model(torch.Generator().manual_seed(args.seed), spec,
                       centers, bw, device=device)
    t0 = time.time()
    result = fit(cfg, spec, model, train_ps, valid_ps, seed=args.seed,
                 verbose=True)
    train_seconds = time.time() - t0
    print(f"[INFO] trained {result.n_epochs_run} epochs in "
          f"{train_seconds:.1f}s, best val loss {result.best_val:.5f}")

    # predict the test rows directly at their (x, y, t)
    serving = from_jax_params(spec, result.params, model_consts(model),
                              device=device)
    test = read_columns(test_path)
    test_coords = np.stack([test["x"], test["y"]], axis=1).astype(np.float32)
    if "t" in test:
        t_test = ((test["t"].astype(np.float32) - 1) / denom)[:, None]
    else:
        t_test = np.zeros((len(test_coords), 1), np.float32)
    preds = predict(serving, test_coords, t_test)
    if cfg.regression_type == "multi-quantile":
        preds = preds[:, len(cfg.quantile_levels) // 2]
    else:
        preds = preds[:, 0]
    z_hat = preds * meta["z_std"] + meta["z_mean"]

    out = args.out or f"submission_{stem.name}.csv"
    write_z_csv(z_hat, out)
    print(f"[INFO] submission -> {out}")
    summary: Dict[str, Any] = {"out": out, "z_hat": z_hat,
                               "n_epochs_run": result.n_epochs_run,
                               "train_seconds": train_seconds}

    # score against competition ground truth when available
    fam = stem.name.split("_")[0]
    ds_idx = args.solution_column or int(stem.name.split("_")[1])
    sol_path = train_path.parent / f"{fam}-solutions.csv"
    if sol_path.exists():
        col = f"z{ds_idx}"
        y_true = solution_column(sol_path, col, len(z_hat))
        if y_true is not None:
            rmse = float(np.sqrt(np.mean((z_hat - y_true) ** 2)))
            mae = float(np.mean(np.abs(z_hat - y_true)))
            print(f"[SCORE] vs {sol_path.name}:{col}  RMSE={rmse:.6f}  "
                  f"MAE={mae:.6f}")
            summary.update(rmse=rmse, mae=mae)
    else:
        print(f"[INFO] no solutions file at {sol_path}")
    return summary


if __name__ == "__main__":
    main()
