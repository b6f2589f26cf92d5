"""Optimizer stack: per-group AdamW, LR tables, clipping, damping, EMA
(port of `st_dadk_tpu/train/optimizer.py`).

`build_lr_tables` is the numpy simulation of the reference's LR timeline
(post-step warmup, basis unfreeze and ramp, torch's recursive cosine), copied
as is. AdamW follows the JAX `adamw_update` formula exactly (decoupled decay
p * (1 - lr*wd), bias-corrected moments, eps after the sqrt) with one LR per
parameter group read from the tables each step; parameters and moments are
updated in place.

The lane forms (`AdamWLanes`, `ema_update_lanes`,
`clip_by_global_norm_lanes_`) run M independent fits whose parameters carry
a leading lane dimension: per-lane LRs, Adam step counts, EMA decays and
clipping norms are device tensors (M,), and an `executes` (M,) mask leaves
a lane's parameters, moments and EMA untouched (JAX loop.py:527-539). They
read no device value on the host. On CUDA tensors each runs the lane
optimizer's multi-tensor kernels, every leaf in one launch a stage
(`ops/lane_optimizer.py`); on CPU tensors their plain versions there, which
loop over parameters, never over lanes.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.ops.lane_optimizer import (adamw_lanes_, clip_lanes_,
                                                  ema_lanes_)


def build_lr_tables(cfg: ExperimentConfig, batches_per_epoch: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-step LR tables (epochs*B,) for the MLP and the basis group, plus
    the per-epoch recorded LR (epochs,)."""
    E = int(cfg.epochs)
    B = int(batches_per_epoch)
    base = float(cfg.lr)
    learnable = bool(cfg.spatial_learnable)
    target = base * float(cfg.basis_lr_ratio)
    unfreeze = int(cfg.basis_unfreeze_epoch) if learnable else 0
    rampup = int(cfg.basis_lr_rampup_epochs) if learnable else 0
    warmup_epochs = int(cfg.warmup_epochs)
    W = warmup_epochs * B
    cosine = cfg.scheduler == "cosine"
    eta_min = base * 0.5
    T_max = E

    initial_basis = (0.0 if unfreeze > 0 else target) if learnable else 0.0
    lr = {"mlp": base, "basis": initial_basis}
    initial = {"mlp": base, "basis": initial_basis}
    mlp_tab = np.zeros(E * B, dtype=np.float64)
    basis_tab = np.zeros(E * B, dtype=np.float64)
    recorded = np.zeros(E, dtype=np.float64)

    t_sched = 0
    for e in range(E):
        if learnable and unfreeze > 0:
            if e == unfreeze:
                lr["basis"] = target * 0.1 if rampup > 0 else target
            elif unfreeze < e < unfreeze + rampup:
                lr["basis"] = target * (0.1 + 0.9 * (e - unfreeze) / rampup)
        for b in range(B):
            s = e * B + b
            mlp_tab[s] = lr["mlp"]
            basis_tab[s] = lr["basis"]
            if s < W:
                factor = (s + 1) / W
                lr["mlp"] = initial["mlp"] * factor
                lr["basis"] = initial["basis"] * factor
        recorded[e] = lr["mlp"]
        if cosine and e >= warmup_epochs:
            t_sched += 1
            num = 1.0 + math.cos(math.pi * t_sched / T_max)
            den = 1.0 + math.cos(math.pi * (t_sched - 1) / T_max)
            for g in (("mlp", "basis") if learnable else ("mlp",)):
                lr[g] = (lr[g] - eta_min) * (num / den) + eta_min

    return (mlp_tab.astype(np.float32), basis_tab.astype(np.float32),
            recorded.astype(np.float64))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """In place: scale the group if its global L2 norm exceeds max_norm
    (torch's clip_grad_norm_ semantics, 1e-6 stabiliser)."""
    total = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale)


def gradient_damping(center_grad: torch.Tensor, centers: torch.Tensor,
                     centers_init: torch.Tensor, threshold: float,
                     strength: float) -> torch.Tensor:
    """Centers that moved beyond `threshold` from their init get
    exponentially damped gradients; (k, 2) or, with lanes, (M, k, 2)."""
    with torch.no_grad():
        distances = torch.linalg.norm(centers - centers_init, dim=-1,
                                      keepdim=True)
        factor = torch.exp(-strength * torch.clamp(distances - threshold,
                                                   min=0.0))
    return center_grad * factor


class AdamW:
    """AdamW over named parameter groups with a per-step LR per group."""

    def __init__(self, groups: Dict[str, Iterable[torch.nn.Parameter]],
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.groups = {g: list(ps) for g, ps in groups.items()}
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.step_count = 0
        self.m = {id(p): torch.zeros_like(p) for ps in self.groups.values()
                  for p in ps}
        self.v = {id(p): torch.zeros_like(p) for ps in self.groups.values()
                  for p in ps}

    @torch.no_grad()
    def step(self, lrs: Dict[str, float]) -> None:
        self.step_count += 1
        t = float(self.step_count)
        # float32 bias corrections, as the JAX step computes them
        bc1 = 1.0 - np.float32(self.b1) ** np.float32(t)
        bc2 = 1.0 - np.float32(self.b2) ** np.float32(t)
        for g, params in self.groups.items():
            lr = float(lrs[g])
            for p in params:
                m, v, grad = self.m[id(p)], self.v[id(p)], p.grad
                m.mul_(self.b1).add_(grad, alpha=1 - self.b1)
                v.mul_(self.b2).addcmul_(grad, grad, value=1 - self.b2)
                upd = (m / float(bc1)) / (torch.sqrt(v / float(bc2)) + self.eps)
                p.mul_(1.0 - lr * self.weight_decay).sub_(lr * upd)


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor],
               decay: float) -> None:
    """In place: shadow = decay*shadow + (1-decay)*param."""
    for s, p in zip(ema, params):
        s.mul_(decay).add_(p, alpha=1.0 - decay)


# ---------------------------------------------------------------------------
# Lane forms
# ---------------------------------------------------------------------------

def clip_by_global_norm_lanes_(grads: List[torch.Tensor], max_norm: float
                               ) -> None:
    """In place: scale each lane's group by its own global L2 norm
    (`clip_by_global_norm_` a lane)."""
    clip_lanes_([(grads, max_norm)])


class AdamWLanes:
    """`AdamW` for parameters with a leading lane dimension M. `groups`
    keeps its order: column j of `step`'s `lrs` (M, n_groups) is group j's
    LR a lane. The Adam step count is per lane and advances only where the
    lane executes; on the card `step` replaces `step_count` by the tensor
    its launch writes."""

    def __init__(self, groups: Dict[str, Iterable[torch.nn.Parameter]],
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.groups = {g: list(ps) for g, ps in groups.items()}
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        params = [p for ps in self.groups.values() for p in ps]
        self.step_count = torch.zeros((params[0].shape[0],), dtype=torch.int32,
                                      device=params[0].device)
        self.m = {id(p): torch.zeros_like(p) for p in params}
        self.v = {id(p): torch.zeros_like(p) for p in params}

    @torch.no_grad()
    def step(self, lrs: torch.Tensor, executes: torch.Tensor) -> None:
        """One update from each parameter's `.grad`: lrs (M, n_groups)
        float32, executes (M,) bool."""
        self.step_count = adamw_lanes_(
            [[(p, self.m[id(p)], self.v[id(p)]) for p in ps]
             for ps in self.groups.values()], lrs, executes, self.step_count,
            self.b1, self.b2, self.eps, self.weight_decay)

    def narrowed(self, groups: Dict[str, Iterable[torch.Tensor]],
                 idx: torch.Tensor) -> "AdamWLanes":
        """This optimizer's state of lanes `idx` for `groups`, the same
        tensors as this one's, of len(idx) lanes (tail compaction)."""
        new = AdamWLanes.__new__(AdamWLanes)
        new.groups = {g: list(ps) for g, ps in groups.items()}
        new.weight_decay = self.weight_decay
        new.b1, new.b2, new.eps = self.b1, self.b2, self.eps
        new.step_count = self.step_count[idx]
        old = [p for ps in self.groups.values() for p in ps]
        cur = [p for ps in new.groups.values() for p in ps]
        new.m = {id(q): self.m[id(p)][idx] for p, q in zip(old, cur)}
        new.v = {id(q): self.v[id(p)][idx] for p, q in zip(old, cur)}
        return new


@torch.no_grad()
def ema_update_lanes(ema: Sequence[torch.Tensor],
                     params: Sequence[torch.Tensor], decay: torch.Tensor,
                     one_minus_decay: torch.Tensor,
                     executes: torch.Tensor) -> None:
    """In place, where a lane executes: shadow = decay*shadow +
    (1-decay)*param with per-lane decay (M,)."""
    ema_lanes_(ema, params, decay, one_minus_decay, executes)
