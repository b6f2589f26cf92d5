"""Matern(nu=1) covariance estimation (copy of
`st_dadk_tpu/utils/covariance.py`): the distance binning, the Matern curve
fit and the nugget convention of the repo's dataset synthesizers
(scripts/synthesize_2b.py, scripts/synthesize_1b3b.py), which reduce a
field to (pair distance, empirical correlation product) samples. scipy is
imported inside the functions.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def matern1_correlation(hh: np.ndarray, s2: float, a: float) -> np.ndarray:
    """Matern nu=1 correlation: s2 * h' K_1(h') with h' = sqrt(2) h / a."""
    from scipy.special import kv
    hh = np.maximum(hh, 1e-12) * np.sqrt(2.0) / a
    return s2 * hh * kv(1, hh)


def fit_matern1(h: np.ndarray, prod: np.ndarray, n_bins: int = 24,
                max_h: float = 0.5) -> Tuple[float, float, float]:
    """Fit (sigma2, range, nugget) to empirical pair correlations.

    `h` are pair distances, `prod` the normalized-field products z_i z_j;
    pairs at h >= max_h are dropped, the rest are distance-binned (bins with
    <= 50 pairs skipped), and a Matern(nu=1) correlation is least-squares
    fitted to the bin means. nugget = max(1 - sigma2, 0): on a unit-variance
    field, whatever the spatial model does not explain at h -> 0.
    """
    from scipy.optimize import curve_fit

    sel = h < max_h
    h, prod = h[sel], prod[sel]
    bins = np.linspace(0, max_h, n_bins + 1)
    which = np.digitize(h, bins) - 1
    hc, rc = [], []
    for b in range(n_bins):
        m = which == b
        if m.sum() > 50:
            hc.append(h[m].mean())
            rc.append(prod[m].mean())
    (s2, a), _ = curve_fit(matern1_correlation, np.asarray(hc),
                           np.asarray(rc), p0=(0.9, 0.1),
                           bounds=([0.05, 0.005], [1.5, 2.0]))
    nugget = max(1.0 - float(s2), 0.0)
    return float(s2), float(a), nugget
