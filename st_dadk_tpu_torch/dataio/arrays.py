"""Point buffers (numpy copy of `st_dadk_tpu/dataio/arrays.py`).

A dataset is a `PointSet`: per-point coords, normalised time and target
plus a 0/1 weight; padding points carry weight 0, so weighted means equal
the reference's ragged-batch means.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class PointSet:
    coords: np.ndarray    # (n, 2) float32
    t: np.ndarray         # (n, 1) float32, normalised to [0, 1]
    y: np.ndarray         # (n, 1) float32
    w: np.ndarray         # (n,) float32, 1.0 = real point, 0.0 = padding
    n_real: int

    def __len__(self) -> int:
        return self.coords.shape[0]


def pointset_from_mask(z_data: np.ndarray, coords: np.ndarray,
                       mask: np.ndarray) -> PointSet:
    """Observed points under a (T, S) mask, row-major (t, s) order; NaN
    targets skipped; time normalised t/(T-1)."""
    T, S = z_data.shape
    tt, ss = np.nonzero(mask)
    y = z_data[tt, ss]
    keep = ~np.isnan(y)
    tt, ss, y = tt[keep], ss[keep], y[keep]
    t_norm = ((tt / (T - 1)).astype(np.float32) if T > 1
              else np.zeros_like(tt, np.float32))
    return PointSet(
        coords=coords[ss].astype(np.float32),
        t=t_norm[:, None],
        y=y.astype(np.float32)[:, None],
        w=np.ones(len(y), dtype=np.float32),
        n_real=int(len(y)),
    )


def pad_pointset(ps: PointSet, capacity: int) -> PointSet:
    """Zero-pad to `capacity` points with weight 0."""
    n = len(ps)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < n points {n}")
    pad = capacity - n
    if pad == 0:
        return ps
    return PointSet(
        coords=np.concatenate([ps.coords, np.zeros((pad, 2), np.float32)]),
        t=np.concatenate([ps.t, np.zeros((pad, 1), np.float32)]),
        y=np.concatenate([ps.y, np.zeros((pad, 1), np.float32)]),
        w=np.concatenate([ps.w, np.zeros(pad, np.float32)]),
        n_real=ps.n_real,
    )


def dense_grid_points(T: int, coords: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """All (t, s) grid points in row-major (t, s) order."""
    S = coords.shape[0]
    coords_rep = np.tile(coords, (T, 1)).astype(np.float32)
    t_vals = (np.arange(T, dtype=np.float32) / (T - 1) if T > 1
              else np.zeros(1, np.float32))
    return coords_rep, np.repeat(t_vals, S)[:, None]
