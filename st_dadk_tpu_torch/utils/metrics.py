"""Evaluation metrics (copy of `st_dadk_tpu/utils/metrics.py`; numpy).

RMSE / MAE / MSE / R^2 with NaN masking, optional per-horizon breakdown for
(B, H, S, 1) tensors (ref stnf/utils/metrics.py:9-81), and distance-binned
spatial metrics (ref :84-146).
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np


def _to_numpy(x) -> np.ndarray:
    return np.asarray(x)


def compute_metrics(y_true, y_pred, per_horizon: bool = False) -> Dict[str, float]:
    y_true = _to_numpy(y_true)
    y_pred = _to_numpy(y_pred)

    yt = y_true.reshape(-1)
    yp = y_pred.reshape(-1)
    valid = ~(np.isnan(yt) | np.isnan(yp))
    yt, yp = yt[valid], yp[valid]

    mse = float(np.mean((yt - yp) ** 2))
    rmse = float(np.sqrt(mse))
    mae = float(np.mean(np.abs(yt - yp)))
    ss_res = float(np.sum((yt - yp) ** 2))
    ss_tot = float(np.sum((yt - np.mean(yt)) ** 2))
    r2 = 1.0 - ss_res / (ss_tot + 1e-8)

    metrics = {"rmse": rmse, "mae": mae, "r2": float(r2), "mse": mse}

    if per_horizon and y_true.ndim == 4:
        H = y_true.shape[1]
        rmse_per_h, mae_per_h = [], []
        for h in range(H):
            yt_h = y_true[:, h].reshape(-1)
            yp_h = y_pred[:, h].reshape(-1)
            m = ~(np.isnan(yt_h) | np.isnan(yp_h))
            yt_h, yp_h = yt_h[m], yp_h[m]
            rmse_per_h.append(float(np.sqrt(np.mean((yt_h - yp_h) ** 2))))
            mae_per_h.append(float(np.mean(np.abs(yt_h - yp_h))))
        metrics["rmse_per_horizon"] = rmse_per_h
        metrics["mae_per_horizon"] = mae_per_h

    return metrics


def compute_spatial_metrics(y_true, y_pred, coords: np.ndarray,
                            n_bins: int = 5) -> Dict[str, list]:
    """RMSE/MAE binned by distance from the origin (ref metrics.py:84-146)."""
    y_true = _to_numpy(y_true)
    y_pred = _to_numpy(y_pred)
    distances = np.sqrt(coords[:, 0] ** 2 + coords[:, 1] ** 2)
    dist_bins = np.linspace(0, distances.max(), n_bins + 1)

    rmse_by_bin, mae_by_bin, bin_centers = [], [], []
    for i in range(n_bins):
        # NOTE half-open last bin reproduces the reference exactly
        # (metrics.py:111-119): sites AT the max distance fall in no bin.
        mask = (distances >= dist_bins[i]) & (distances < dist_bins[i + 1])
        if not mask.any():
            continue
        yt = y_true[:, :, mask, :].reshape(-1)
        yp = y_pred[:, :, mask, :].reshape(-1)
        m = ~(np.isnan(yt) | np.isnan(yp))
        yt, yp = yt[m], yp[m]
        if len(yt) > 0:
            rmse_by_bin.append(float(np.sqrt(np.mean((yt - yp) ** 2))))
            mae_by_bin.append(float(np.mean(np.abs(yt - yp))))
        else:
            rmse_by_bin.append(float("nan"))
            mae_by_bin.append(float("nan"))
        bin_centers.append(float((dist_bins[i] + dist_bins[i + 1]) / 2))

    return {"bin_centers": bin_centers,
            "rmse_by_distance": rmse_by_bin,
            "mae_by_distance": mae_by_bin}


def print_metrics(metrics: Dict[str, float], prefix: str = "") -> None:
    print(f"{prefix} Metrics:")
    print(f"  RMSE: {metrics['rmse']:.6f}")
    print(f"  MAE:  {metrics['mae']:.6f}")
    print(f"  R2:   {metrics['r2']:.6f}")
    if "rmse_per_horizon" in metrics:
        print(f"  RMSE per horizon: {metrics['rmse_per_horizon']}")
