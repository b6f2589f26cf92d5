"""Observation-mask design (numpy copy of `st_dadk_tpu/dataio/obs_design.py`).

Seed-exact with the JAX package and the reference: the same seed issues the
same sequence of draws and gives identical masks. The draws come from a
private `np.random.RandomState` (the legacy global functions delegate to
one, so the stream is the same) instead of reseeding the global stream;
pass `rng` to continue a stream across calls.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _rng(seed: Optional[int], rng: Optional[np.random.RandomState]
         ) -> np.random.RandomState:
    if rng is not None:
        return rng
    return np.random.RandomState(seed)


def spatial_obs_probs(coords: np.ndarray, pattern: str = "uniform",
                      intensity: float = 1.0) -> Optional[np.ndarray]:
    """Per-site relative observation weights: 'corner' is
    1/(1 + intensity ||s||^2)^2, peaked at (0, 0); 'uniform' is None."""
    if pattern == "uniform" or pattern is None:
        return None
    if pattern == "corner":
        dist_sq = coords[:, 0] ** 2 + coords[:, 1] ** 2
        return 1.0 / (1.0 + intensity * dist_sq) ** 2
    raise ValueError(f"Unknown pattern: {pattern}")


def sample_observations(z_data: np.ndarray, coords: np.ndarray,
                        obs_method: str = "site-wise", obs_ratio: float = 0.5,
                        obs_weights: Optional[np.ndarray] = None,
                        seed: Optional[int] = None,
                        rng: Optional[np.random.RandomState] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(obs_mask (T, S) bool, indices of sites with >= 1 observation)."""
    r = _rng(seed, rng)
    T, S = z_data.shape
    if obs_weights is not None:
        obs_probs = np.clip(obs_weights / obs_weights.mean() * obs_ratio, 0, 1)
    else:
        obs_probs = np.ones(S) * obs_ratio

    if obs_method == "site-wise":
        n_obs_sites = int(S * obs_ratio)
        p = obs_probs / obs_probs.sum()
        obs_sites = r.choice(S, size=n_obs_sites, replace=False, p=p)
        obs_mask = np.zeros((T, S), dtype=bool)
        obs_mask[:, obs_sites] = True
        return obs_mask, obs_sites
    if obs_method == "random":
        obs_mask = r.rand(T, S) < obs_probs[np.newaxis, :].repeat(T, axis=0)
        return obs_mask, np.where(obs_mask.any(axis=0))[0]
    raise ValueError(f"Unknown obs_method: {obs_method}")


def split_train_valid(obs_mask: np.ndarray, obs_sites: np.ndarray,
                      split_method: str = "site-wise",
                      train_ratio: float = 0.8, seed: Optional[int] = None,
                      rng: Optional[np.random.RandomState] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Split observed points into (train_mask, valid_mask)."""
    r = _rng(seed, rng)
    T, S = obs_mask.shape
    train_mask = np.zeros((T, S), dtype=bool)
    valid_mask = np.zeros((T, S), dtype=bool)
    if split_method == "site-wise":
        n_train_sites = int(len(obs_sites) * train_ratio)
        shuffled = np.array(obs_sites).copy()
        r.shuffle(shuffled)
        train_sites, valid_sites = shuffled[:n_train_sites], \
            shuffled[n_train_sites:]
        train_mask[:, train_sites] = obs_mask[:, train_sites]
        valid_mask[:, valid_sites] = obs_mask[:, valid_sites]
        return train_mask, valid_mask
    if split_method == "random":
        obs_indices = np.argwhere(obs_mask)          # row-major (t, s) order
        n_obs = len(obs_indices)
        n_train = int(n_obs * train_ratio)
        shuffled_idx = r.permutation(n_obs)
        train_pts = obs_indices[shuffled_idx[:n_train]]
        valid_pts = obs_indices[shuffled_idx[n_train:]]
        train_mask[train_pts[:, 0], train_pts[:, 1]] = True
        valid_mask[valid_pts[:, 0], valid_pts[:, 1]] = True
        return train_mask, valid_mask
    raise ValueError(f"Unknown split_method: {split_method}")
