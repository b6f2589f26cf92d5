"""The reference's data set-up of one fit: the observation mask, the
train/validation split and the point buffers, worked out again from the
field and the experiment seed.

The published protocol (ST-DADK `stnf/dataio`): site-wise observation of
int(S * ratio) sites drawn without replacement by numpy's legacy stream
seeded with the experiment seed, site weights 1 / (1 + intensity |s|^2)^2
for the corner pattern; a random split of the observed points (row-major
(t, s) order) by a permutation from the stream seeded with seed + 10000;
time normalised t / (T - 1); the test set the unobserved points. A
minibatch of a fit halves the configured batch until an epoch has ten
batches or more, and the training points are padded with weight-0 rows to
a whole number of batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class Points:
    coords: np.ndarray   # (n, 2) float32
    t: np.ndarray        # (n, 1) float32
    y: np.ndarray        # (n, 1) float32
    w: np.ndarray        # (n,) float32

    def padded(self, cap: int) -> "Points":
        pad = cap - len(self.w)
        if pad < 0:
            raise ValueError(f"{len(self.w)} points over a capacity of {cap}")
        z = lambda a: np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], np.float32)])
        return Points(z(self.coords), z(self.t), z(self.y), z(self.w))

    def packed(self) -> np.ndarray:
        """(n, 5): coords | t | y | w."""
        return np.concatenate([self.coords, self.t, self.y, self.w[:, None]],
                              axis=1)


def observation_split(z: np.ndarray, coords: np.ndarray, cfg: Dict,
                      seed: int) -> Dict[str, np.ndarray]:
    """{'train', 'valid', 'test'} (T, S) bool masks of experiment `seed`."""
    T, S = z.shape
    if cfg["obs_method"] != "site-wise" or cfg["split_method"] != "random":
        raise ValueError("the reference follows site-wise observation and a "
                         "random split")
    ratio = float(cfg["obs_ratio"])
    if cfg["obs_spatial_pattern"] == "corner":
        wts = 1.0 / (1.0 + float(cfg["obs_spatial_intensity"])
                     * (coords[:, 0] ** 2 + coords[:, 1] ** 2)) ** 2
        probs = np.clip(wts / wts.mean() * ratio, 0, 1)
    else:
        probs = np.ones(S) * ratio
    rs = np.random.RandomState(seed)
    sites = rs.choice(S, size=int(S * ratio), replace=False,
                      p=probs / probs.sum())
    obs = np.zeros((T, S), bool)
    obs[:, sites] = True
    rs = np.random.RandomState(seed + 10000)
    idx = np.argwhere(obs)
    perm = rs.permutation(len(idx))
    n_train = int(len(idx) * float(cfg["train_ratio"]))
    train = np.zeros((T, S), bool)
    valid = np.zeros((T, S), bool)
    tr, va = idx[perm[:n_train]], idx[perm[n_train:]]
    train[tr[:, 0], tr[:, 1]] = True
    valid[va[:, 0], va[:, 1]] = True
    return {"train": train, "valid": valid, "test": ~obs}


def points(z: np.ndarray, coords: np.ndarray, mask: np.ndarray) -> Points:
    T = z.shape[0]
    tt, ss = np.nonzero(mask)
    y = z[tt, ss]
    keep = ~np.isnan(y)
    tt, ss, y = tt[keep], ss[keep], y[keep]
    return Points(coords[ss].astype(np.float32),
                  (tt / (T - 1)).astype(np.float32)[:, None],
                  y.astype(np.float32)[:, None],
                  np.ones(len(y), np.float32))


def batch_size(n_train: int, configured: int) -> int:
    bs = int(configured)
    while n_train / bs < 10 and bs > 1:
        bs //= 2
    return bs


def grid(z: np.ndarray, coords: np.ndarray):
    """Every (t, s) point in row-major order: (coords, t (n, 1))."""
    T, S = z.shape
    return (np.tile(coords, (T, 1)).astype(np.float32),
            np.repeat(np.arange(T, dtype=np.float32) / (T - 1), S)[:, None])
