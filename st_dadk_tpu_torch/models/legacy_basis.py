"""Legacy standalone Wendland basis embedding (port of
`st_dadk_tpu/models/legacy_basis.py`).

Hard-coded multi-resolution grids 5x5 (theta 0.625), 9x9 (theta 0.3125) and
11x11 (theta 0.25): 25 + 81 + 121 = 227 centers. phi goes through the
materialised-phi kernel wrapper (`ops/spatial_basis_kernels.py`), so on the
card it launches the phi forward kernel.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from st_dadk_tpu_torch.ops.basis import wendland_c4
from st_dadk_tpu_torch.ops.spatial_basis_kernels import \
    spatial_basis_embed_kernel

LEGACY_GRIDS = ((25, 0.625), (81, 0.3125), (121, 0.25))


def wendland_phi(r: torch.Tensor) -> torch.Tensor:
    """phi(r) = (1-r)^6_+ (35 r^2 + 18 r + 3)/3."""
    return wendland_c4(r)


def legacy_centers_and_bandwidths() -> Tuple[np.ndarray, np.ndarray]:
    """The 5x5 / 9x9 / 11x11 grids with a fixed theta a resolution:
    centers (227, 2), bandwidths (227,), float32."""
    centers, bws = [], []
    for k, theta in LEGACY_GRIDS:
        side = int(np.sqrt(k))
        ax = np.linspace(0.0, 1.0, side, dtype=np.float64)
        xx, yy = np.meshgrid(ax, ax, indexing="ij")
        centers.append(np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float32))
        bws.append(np.full((k,), theta, np.float32))
    return np.concatenate(centers), np.concatenate(bws)


def embed(coords: torch.Tensor) -> torch.Tensor:
    """(N, 2) coords in [0,1]^2 -> (N, 227) Wendland basis values, on the
    coords' device."""
    centers, bws = legacy_centers_and_bandwidths()
    return spatial_basis_embed_kernel(
        coords, torch.as_tensor(centers, device=coords.device),
        torch.as_tensor(bws, device=coords.device), "wendland")
