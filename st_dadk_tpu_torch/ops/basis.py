"""Radial basis functions and basis-matrix construction (plain PyTorch).

Port of `st_dadk_tpu/ops/basis.py`. Same math, same calibration factors,
same `sqrt(max(d2, 1e-24))` guard; this module is the plain version the
hand-written CUDA kernels (`ops/fused_first_layer.py`) are held against.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

CALIBRATION_FACTORS = {
    "wendland": 1.000000,
    "gaussian": 0.223477,
    "triangular": 0.654714,
}

BASIS_IDS = {"wendland": 0, "gaussian": 1, "triangular": 2}


def wendland_c4(r: torch.Tensor) -> torch.Tensor:
    """Wendland C4 on [0, 1], clamped at r = 1 like the reference."""
    r = torch.clamp(r, max=1.0)
    one_minus = 1.0 - r
    return one_minus ** 6 * (35.0 * r * r + 18.0 * r + 3.0) / 3.0


def gaussian_rbf(r: torch.Tensor) -> torch.Tensor:
    return exp_rn(-0.5 * r * r)


def triangular_basis(r: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - r, min=0.0)


_BASIS_FNS = (wendland_c4, gaussian_rbf, triangular_basis)


def apply_basis(r: torch.Tensor, basis_function: str) -> torch.Tensor:
    if basis_function not in BASIS_IDS:
        raise ValueError(f"Unknown basis function: {basis_function}. "
                         f"Choose from {list(BASIS_IDS)}")
    return _BASIS_FNS[BASIS_IDS[basis_function]](r)


def basis_matrix(coords: torch.Tensor, centers: torch.Tensor,
                 inv_bw: torch.Tensor, basis_function: str) -> torch.Tensor:
    """phi (N, k) from inverse calibrated bandwidths, r = dist * inv_bw: the
    form the fused kernels compute. The max-guard keeps sqrt's gradient
    finite when a learnable center lands exactly on a data point. Leading
    lane dimensions broadcast: coords (M, N, 2), centers (M, k, 2) and
    inv_bw (M, k) give phi (M, N, k), each lane from its own operands."""
    dx = coords[..., 0:1] - centers[..., None, :, 0]
    dy = coords[..., 1:2] - centers[..., None, :, 1]
    dist = sqrt_rn(torch.clamp(dx * dx + dy * dy, min=1e-24))
    return apply_basis(dist * inv_bw[..., None, :], basis_function)


def _on_cpu32(x: torch.Tensor) -> bool:
    return x.device.type == "cpu" and x.dtype == torch.float32


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of float32 `x`, as the card's
    `torch.sqrt` and the kernels' `__fsqrt_rn` give it. On the CPU, torch
    takes a float32 tensor's square root (and its `exp`) from MKL's vector
    math in chunks on its OpenMP threads: up to 1 ulp off, and now and then
    one thread's whole chunk comes from MKL's reduced-accuracy (VML_EP)
    kernel of its AVX2/SSE4.2 code path, about 12 bits accurate (a relative
    error up to 3.2e-4), although torch asks for VML_HA; the float64 call
    can take the same fault (about 35 bits). There the root is taken in
    float64 and refined by one Newton step, whose add and divide are exact
    IEEE operations, then rounded once: the correctly rounded float32 root
    whatever the vector-math call returned."""
    if _on_cpu32(x):
        x64 = x.double()
        r = torch.sqrt(x64)
        return torch.where(r > 0, 0.5 * (r + x64 / r), r).float()
    return torch.sqrt(x)


def exp_rn(x: torch.Tensor) -> torch.Tensor:
    """exp of float32 `x`; on the CPU in float64 and rounded once, for the
    reason `sqrt_rn` gives: correctly rounded, and within one float32 ulp
    should the fault hit the float64 call (which has no exact refinement
    without another vector-math call). The card's `torch.exp` is
    unchanged."""
    if _on_cpu32(x):
        return torch.exp(x.double()).float()
    return torch.exp(x)


def spatial_basis_embed(coords: torch.Tensor, centers: torch.Tensor,
                        bandwidths: torch.Tensor,
                        basis_function: str = "wendland") -> torch.Tensor:
    """phi(s): (N, k) basis matrix (coords (N, 2), centers (k, 2),
    bandwidths (k,)), r = dist / (bandwidth * calibration)."""
    inv_bw = 1.0 / (bandwidths * CALIBRATION_FACTORS[basis_function])
    return basis_matrix(coords, centers, inv_bw, basis_function)


def temporal_basis_embed(t: torch.Tensor, centers: torch.Tensor,
                         bandwidths: torch.Tensor) -> torch.Tensor:
    """psi(t): (N, k_t) Gaussian RBF embedding of normalised time."""
    t = t.reshape(-1, 1)
    diff = (t - centers[None, :]) / bandwidths[None, :]
    return exp_rn(-0.5 * diff * diff)


# ---------------------------------------------------------------------------
# Fixed-grid initializers (numpy, once per fit)
# ---------------------------------------------------------------------------

def uniform_grid_centers(n_centers: Sequence[int]
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-resolution regular grids over [0,1]^2; bandwidth = 2.5 x
    spacing. Each k must be a perfect square."""
    centers_list: List[np.ndarray] = []
    bw_list: List[np.ndarray] = []
    for k in n_centers:
        side = int(math.isqrt(int(k)))
        if side * side != k:
            raise ValueError(f"n_centers must be perfect squares, got {k}")
        ax = np.linspace(0.0, 1.0, side, dtype=np.float64)
        xx, yy = np.meshgrid(ax, ax, indexing="ij")
        centers_list.append(
            np.stack([xx.ravel(), yy.ravel()], axis=-1).astype(np.float32))
        spacing = 1.0 / (side - 1) if side > 1 else 1.0
        bw_list.append(np.full((k,), 2.5 * spacing, dtype=np.float32))
    return np.concatenate(centers_list, axis=0), np.concatenate(bw_list, axis=0)


def temporal_grid_centers(n_centers: Sequence[int]
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-resolution regular 1-D grids over [0,1]; bandwidth = 2.5 x
    spacing."""
    centers_list: List[np.ndarray] = []
    bw_list: List[np.ndarray] = []
    for n in n_centers:
        centers_list.append(np.linspace(0.0, 1.0, int(n)).astype(np.float32))
        spacing = 1.0 / (n - 1) if n > 1 else 1.0
        bw_list.append(np.full((int(n),), 2.5 * spacing, dtype=np.float32))
    return np.concatenate(centers_list), np.concatenate(bw_list)


def uniform_bandwidth_for(k: int) -> float:
    """Uniform-grid bandwidth for a resolution of k centers (the GMM init's
    clipping floor)."""
    side = int(math.isqrt(int(k)))
    spacing = 1.0 / (side - 1) if side > 1 else 1.0
    return 2.5 * spacing
