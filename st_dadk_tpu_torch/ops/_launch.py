"""Argument checks and launch helpers shared by the kernel wrappers.

A wrapper takes its plain PyTorch version when every tensor lies on the
CPU (`on_cpu`); on CUDA tensors it checks dtype, shape and contiguity,
launches its kernel on the current stream, and raises on a launch error.
"""
from __future__ import annotations

from typing import Tuple

import torch

from st_dadk_tpu_torch.ops.basis import BASIS_IDS


def on_cpu(what: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; raises on anything else."""
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: tensors on mixed devices "
                         f"{[str(t.device) for t in tensors]}")
    return False


def check(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_basis(what: str, coords: torch.Tensor, centers: torch.Tensor,
                inv_bw: torch.Tensor, basis_id: int,
                *dims: int) -> Tuple[int, int]:
    """(n, k) after checking coords (n, 2), centers (k, 2), inv_bw (k,),
    the basis id, and that n, k and `dims` are non-empty and fit int32."""
    n, k = coords.shape[0], centers.shape[0]
    if min(n, k, *dims) < 1:
        raise ValueError(f"{what}: empty shape n={n} k={k} {dims}")
    if max(n, k, *dims) * 2 >= 2 ** 31:
        raise ValueError(f"{what}: a dimension exceeds int32")
    if basis_id not in BASIS_IDS.values():
        raise ValueError(f"unknown basis id {basis_id}")
    check("coords", coords, (n, 2))
    check("centers", centers, (k, 2))
    check("inv_bw", inv_bw, (k,))
    return n, k


def check_basis_lanes(what: str, coords: torch.Tensor, centers: torch.Tensor,
                      inv_bw: torch.Tensor, basis_id: int,
                      *dims: int) -> Tuple[Tuple[int, ...], int, int]:
    """(lead, n, k) of a call with or without a lane axis: lead is () for
    coords (n, 2), centers (k, 2), inv_bw (k,), and (M,) for coords
    (M, n, 2), centers (M, k, 2), inv_bw (M, k). Checks as `check_basis`,
    and that M lanes of the largest operand still index within int32 a
    lane (the kernels offset lanes in size_t)."""
    if coords.dim() == 2:
        n, k = check_basis(what, coords, centers, inv_bw, basis_id, *dims)
        return (), n, k
    if coords.dim() != 3 or centers.dim() != 3:
        raise ValueError(f"{what}: coords must be (n, 2) or (M, n, 2), got "
                         f"{tuple(coords.shape)}, centers "
                         f"{tuple(centers.shape)}")
    lanes, n, k = coords.shape[0], coords.shape[1], centers.shape[1]
    if min(lanes, n, k, *dims) < 1:
        raise ValueError(f"{what}: empty shape M={lanes} n={n} k={k} {dims}")
    if max(n, k, *dims) * 2 >= 2 ** 31:
        raise ValueError(f"{what}: a dimension exceeds int32")
    if basis_id not in BASIS_IDS.values():
        raise ValueError(f"unknown basis id {basis_id}")
    check("coords", coords, (lanes, n, 2))
    check("centers", centers, (lanes, k, 2))
    check("inv_bw", inv_bw, (lanes, k))
    return (lanes,), n, k


def raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {rc}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
