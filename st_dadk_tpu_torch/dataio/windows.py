"""Sliding-window forecasting datasets (numpy copy of
`st_dadk_tpu/dataio/windows.py`).

Every window of a (T, S) series is gathered once into dense stacked arrays,
(W, L, n_obs, 1) histories and (W, H, n_obs, 1) targets, plus optional
covariates; `models/forecaster.py` flattens them into per-(window, site)
rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass
class WindowDataset:
    """All sliding windows of a (T, S) series, densely stacked.

    y_hist: (W, L, n_obs, 1)   context at observed sites
    y_fut:  (W, H, n_obs, 1)   forecast target at observed sites
    obs_coords: (n_obs, 2)
    t0: (W,) window start indices
    X_hist / X_fut: optional covariates (W, L, n_obs, p) / (W, n_obs, p)
    """
    y_hist: np.ndarray
    y_fut: np.ndarray
    obs_coords: np.ndarray
    t0: np.ndarray
    X_hist: Optional[np.ndarray] = None
    X_fut: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.y_hist.shape[0]

    @property
    def p_covariates(self) -> int:
        return 0 if self.X_hist is None else self.X_hist.shape[-1]


def _time_features(t_norm: np.ndarray, encoding: str) -> np.ndarray:
    if encoding == "sinusoidal":
        return np.stack([np.sin(2 * np.pi * t_norm),
                         np.cos(2 * np.pi * t_norm)], axis=-1)
    return t_norm[..., None]


def build_window_dataset(
    z_full: np.ndarray,
    coords: np.ndarray,
    obs_indices: np.ndarray,
    L: int,
    H: int,
    stride: int = 1,
    t0_min: Optional[int] = None,
    t0_max: Optional[int] = None,
    use_coords_cov: bool = False,
    use_time_cov: bool = False,
    time_encoding: str = "linear",
) -> WindowDataset:
    """Gather every valid window [t0-L, t0) -> [t0, t0+H) at observed sites
    (semantics of KAUSTWindowDataset, kaust_loader.py:258-397)."""
    T, S = z_full.shape
    n_obs = len(obs_indices)
    if t0_min is None:
        t0_min = L
    if t0_max is None:
        t0_max = T - H + 1
    if t0_min < L:
        # negative hist indices would WRAP via numpy indexing and leak
        # future timesteps into the context
        raise ValueError(f"t0_min={t0_min} < L={L}: windows would need "
                         "history before t=0")
    t0s = np.arange(t0_min, t0_max, stride)
    W = len(t0s)

    z_obs = z_full[:, obs_indices]                     # (T, n_obs)
    hist_idx = t0s[:, None] + np.arange(-L, 0)[None]   # (W, L)
    fut_idx = t0s[:, None] + np.arange(H)[None]        # (W, H)
    y_hist = z_obs[hist_idx][..., None].astype(np.float32)
    y_fut = z_obs[fut_idx][..., None].astype(np.float32)

    X_hist = X_fut = None
    feats_h, feats_f = [], []
    if use_coords_cov:
        oc = coords[obs_indices].astype(np.float32)    # (n_obs, 2)
        feats_h.append(np.broadcast_to(oc[None, None], (W, L, n_obs, 2)))
        feats_f.append(np.broadcast_to(oc[None], (W, n_obs, 2)))
    if use_time_cov:
        t_hist_norm = (hist_idx / T).astype(np.float32)           # (W, L)
        tf_h = _time_features(t_hist_norm, time_encoding)         # (W, L, c)
        feats_h.append(np.broadcast_to(tf_h[:, :, None, :],
                                       (W, L, n_obs, tf_h.shape[-1])))
        t_fut_norm = (t0s / T).astype(np.float32)                 # (W,)
        tf_f = _time_features(t_fut_norm, time_encoding)          # (W, c)
        feats_f.append(np.broadcast_to(tf_f[:, None, :],
                                       (W, n_obs, tf_f.shape[-1])))
    if feats_h:
        X_hist = np.concatenate([f.astype(np.float32) for f in feats_h], -1)
        X_fut = np.concatenate([f.astype(np.float32) for f in feats_f], -1)

    return WindowDataset(y_hist=y_hist, y_fut=y_fut,
                         obs_coords=coords[obs_indices].astype(np.float32),
                         t0=t0s, X_hist=X_hist, X_fut=X_fut)


def train_valid_window_split(
    z_train: np.ndarray,
    coords: np.ndarray,
    obs_indices: np.ndarray,
    L: int,
    H: int,
    val_ratio: float = 0.2,
    **kw,
) -> Tuple[WindowDataset, WindowDataset]:
    """Split windows by TARGET time range: context may come from anywhere in
    z_train, but targets before/after the split point go to train/valid
    (ref create_dataloaders, kaust_loader.py:400-480)."""
    T_tr = z_train.shape[0]
    t0_max = T_tr - H
    if t0_max - L + 1 < 2:
        raise ValueError(
            f"T={T_tr} is too short for a train/valid window split with "
            f"L={L}, H={H}: need at least L+H+1 timesteps (2 windows)")
    # clamp so BOTH splits are non-empty and every valid window's history
    # stays inside [0, t0): an unclamped t0_split < L used to hand
    # build_window_dataset negative hist indices (future-data leakage via
    # numpy wraparound) and an empty train range
    t0_split = min(max(int(t0_max * (1 - val_ratio)), L + 1), t0_max)
    train = build_window_dataset(z_train, coords, obs_indices, L, H,
                                 t0_min=L, t0_max=t0_split, **kw)
    valid = build_window_dataset(z_train, coords, obs_indices, L, H,
                                 t0_min=t0_split, t0_max=t0_max + 1, **kw)
    return train, valid


def prepare_test_context(z_train: np.ndarray, coords: np.ndarray,
                         obs_indices: np.ndarray, L: int) -> Dict[str, np.ndarray]:
    """Last-L context for forecasting past the training range
    (ref kaust_loader.py:483-515)."""
    y_hist_obs = z_train[-L:, obs_indices]
    return {
        "obs_coords": coords[obs_indices].astype(np.float32)[None],
        "target_coords": coords.astype(np.float32)[None],
        "y_hist_obs": y_hist_obs.astype(np.float32)[None, ..., None],
    }
