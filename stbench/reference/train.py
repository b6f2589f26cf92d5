"""The reference's training step, validation and scores of one fit.

The published loop (ST-DADK `stnf/train`), one fit at a time:

  - each epoch permutes the padded training buffer: with every lane of a
    batch at one batch count, by the keyed multiply-xorshift bijection
    whose four values the fit's generator (seeded with the experiment seed,
    on the fit's device) draws at the epoch's start;
  - dropout's keep masks come from one generator of the batch, seeded with
    its first experiment seed, one (lanes, batch, sum(hidden)) uniform
    block a step, of which a fit keeps its own row;
  - the loss is the weighted mean check loss over the quantile levels,
    plus, for a learnable basis, the domain penalty and the first layer's
    sparsity penalty (sparse group) as configured;
  - the centers' gradient is damped by exp(-strength * max(|c - c0| -
    threshold, 0)), then each group (basis, MLP) is clipped to its global
    norm (0.1 x and 1 x grad_clip, 1e-6 stabiliser);
  - AdamW (b 0.9 / 0.999, eps 1e-8 after the root, decoupled decay p (1 -
    lr wd)) with the step's learning rates from the warm-up / basis-unfreeze
    / cosine timeline, then the EMA with decay 1 - 1 / (10 B).

Nothing here imports the program under test.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from stbench.reference.model import Mm, Net, f32_mm


def lr_table(cfg: Dict, B: int) -> np.ndarray:
    """(epochs * B, 2) float32: the MLP's and the basis group's learning
    rate of each step. The warm-up scales a step's rate after the step
    (the first step runs at the base rate)."""
    E, base = int(cfg["epochs"]), float(cfg["lr"])
    learnable = bool(cfg["spatial_learnable"])
    target = base * float(cfg["basis_lr_ratio"])
    unfreeze = int(cfg["basis_unfreeze_epoch"]) if learnable else 0
    rampup = int(cfg["basis_lr_rampup_epochs"]) if learnable else 0
    warm = int(cfg["warmup_epochs"])
    W = warm * B
    eta_min = base * 0.5
    init_basis = (0.0 if unfreeze > 0 else target) if learnable else 0.0
    lr = {"mlp": base, "basis": init_basis}
    start = dict(lr)
    tab = np.zeros((E * B, 2), np.float64)
    t_sched = 0
    for e in range(E):
        if learnable and unfreeze > 0:
            if e == unfreeze:
                lr["basis"] = target * 0.1 if rampup > 0 else target
            elif unfreeze < e < unfreeze + rampup:
                lr["basis"] = target * (0.1 + 0.9 * (e - unfreeze) / rampup)
        for b in range(B):
            s = e * B + b
            tab[s] = lr["mlp"], lr["basis"]
            if s < W:
                lr["mlp"] = start["mlp"] * (s + 1) / W
                lr["basis"] = start["basis"] * (s + 1) / W
        if cfg["scheduler"] == "cosine" and e >= warm:
            t_sched += 1
            num = 1.0 + math.cos(math.pi * t_sched / E)
            den = 1.0 + math.cos(math.pi * (t_sched - 1) / E)
            for g in (("mlp", "basis") if learnable else ("mlp",)):
                lr[g] = (lr[g] - eta_min) * (num / den) + eta_min
    return tab.astype(np.float32)


def bijection(r: torch.Tensor, cap: int) -> torch.Tensor:
    """The keyed permutation of [0, cap): three rounds of an odd multiply
    mod 2^w and a right xorshift after an xor with r[3], on the next power
    of two 2^w >= cap, restricted to [0, cap) in its order."""
    big = cap if cap & (cap - 1) == 0 else 1 << int(cap).bit_length()
    w = big.bit_length() - 1
    mask = big - 1
    s1, s2 = max(1, w // 2), max(1, w // 3)
    r = r.to(torch.int64)
    x = torch.arange(big, dtype=torch.int64, device=r.device)
    x = x ^ (r[3] & mask)
    for i in range(3):
        x = (x * (2 * r[i] + 1)) & mask
        x = x ^ (x >> (s1 if i % 2 == 0 else s2))
    return x[x < cap]


def check_loss(pred: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    e = y - pred
    rho = torch.maximum((q - 1.0) * e, q * e)
    return torch.sum(rho * w[:, None]) / (
        torch.clamp(torch.sum(w), min=1e-12) * rho.shape[1])


def penalties(net: Net, params: Dict[str, torch.Tensor], cfg: Dict
              ) -> torch.Tensor:
    total = torch.zeros((), device=params["mlp.out.b"].device)
    if net.learnable and float(cfg["domain_penalty_weight"]) > 0:
        c = params["basis.centers"]
        total = total + float(cfg["domain_penalty_weight"]) * torch.sum(
            (torch.relu(-c) + torch.relu(c - 1.0)) ** 2)
    kind = cfg["sparsity_penalty_type"]
    if kind != "none":
        w0 = params["mlp.linear_0.w"]
        l1, lg = float(cfg["sparsity_lambda_l1"]), \
            float(cfg["sparsity_lambda_group"])
        blocks = []
        if cfg["sparsity_apply_to_spatial"]:
            blocks.append(w0[:net.ks])
        if cfg["sparsity_apply_to_temporal"]:
            blocks.append(w0[net.ks:])
        for b in blocks:
            s = torch.sum(b * b, dim=-1)
            nz = s > 0
            group = torch.sqrt(torch.where(nz, s, torch.ones_like(s))) * nz
            l1_term = torch.sum(torch.where(b != 0, torch.abs(b),
                                            torch.zeros_like(b)))
            if kind == "element":
                total = total + l1 * l1_term
            elif kind == "group":
                total = total + lg * torch.sum(group)
            else:
                total = total + lg * torch.sum(group) + l1 * l1_term
    return total


def follow(net: Net, cfg: Dict, params0: Dict[str, torch.Tensor],
           consts: Dict[str, torch.Tensor], train: np.ndarray, bs: int,
           fit_seed: int, batch_seed: int, lanes: int, lane: int,
           steps: int, mm: Mm = f32_mm) -> Dict:
    """The first `steps` steps of one fit from `params0`, on its padded
    training rows `train` (cap, 5). Returns each step's loss, the first
    step's gradient (as the optimizer gets it), and the parameters and EMA
    after the last step."""
    dev = params0["mlp.out.b"].device
    cap = train.shape[0]
    B = cap // bs
    rows = torch.as_tensor(train, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(fit_seed))
    big = cap if cap & (cap - 1) == 0 else 1 << int(cap).bit_length()
    order = bijection(torch.randint(0, big, (4,), generator=gen, device=dev),
                      cap)
    drop = torch.Generator(device=dev).manual_seed(int(batch_seed))
    width = int(sum(net.hidden))
    lrs = lr_table(cfg, B)
    q = torch.tensor([float(x) for x in cfg["quantile_levels"]],
                     dtype=torch.float32, device=dev)
    groups = {"mlp": [n for n in net.names() if n.startswith("mlp.")]}
    if net.learnable:
        groups["basis"] = ["basis.centers", "basis.log_bandwidths"]
    p = {k: v.detach().clone() for k, v in params0.items()}
    ema = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    decay = float(np.float32(1.0 - 1.0 / (10.0 * B)))
    one_minus = float(np.float32(1.0 - np.float32(decay)))
    wd = float(cfg["weight_decay"])
    clip = float(cfg["grad_clip"])
    losses: List[float] = []
    grad1: Dict[str, torch.Tensor] = {}
    for s in range(steps):
        if s >= B:
            raise ValueError("the reference follows the first epoch only")
        batch = rows[order[s * bs:(s + 1) * bs]]
        keep = torch.rand((lanes, bs, width), generator=drop,
                          device=dev)[lane] < (1.0 - net.dropout)
        leaves = {k: t.clone().requires_grad_(True) for k, t in p.items()}
        pred = net.forward(leaves, consts, batch[:, 0:2], batch[:, 2:3],
                           keep, mm)
        loss = check_loss(pred, batch[:, 3:4], batch[:, 4], q) \
            + penalties(net, leaves, cfg)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True)))
        grads = {k: (g if g is not None else torch.zeros_like(p[k]))
                 for k, g in grads.items()}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if net.learnable and cfg["gradient_damping"]:
                dist = torch.linalg.norm(
                    p["basis.centers"] - consts["centers0"], dim=-1,
                    keepdim=True)
                grads["basis.centers"] = grads["basis.centers"] * torch.exp(
                    -float(cfg["damping_strength"]) * torch.clamp(
                        dist - float(cfg["damping_threshold"]), min=0.0))
            if clip > 0:
                for g, names in groups.items():
                    cap_norm = clip * (0.1 if g == "basis" else 1.0)
                    norm = torch.sqrt(sum(torch.sum(grads[n] ** 2)
                                          for n in names))
                    scale = torch.clamp(cap_norm / (norm + 1e-6), max=1.0)
                    for n in names:
                        grads[n] = grads[n] * scale
            if s == 0:
                grad1 = {k: g.clone() for k, g in grads.items()}
            t = float(s + 1)
            bc1 = 1.0 - float(np.float32(0.9) ** np.float32(t))
            bc2 = 1.0 - float(np.float32(0.999) ** np.float32(t))
            for g, names in groups.items():
                lr = float(lrs[s, 0 if g == "mlp" else 1])
                for n in names:
                    m[n] = m[n] * 0.9 + grads[n] * (1 - 0.9)
                    v2[n] = v2[n] * 0.999 + grads[n] * grads[n] * (1 - 0.999)
                    upd = (m[n] / bc1) / (torch.sqrt(v2[n] / bc2) + 1e-8)
                    p[n] = p[n] * (1.0 - lr * wd) - lr * upd
            for n in p:
                ema[n] = ema[n] * decay + p[n] * one_minus
    return {"losses": losses, "grad1": grad1, "params": p, "ema": ema}


def validation(net: Net, cfg: Dict, params: Dict[str, torch.Tensor],
               consts: Dict[str, torch.Tensor], valid: np.ndarray,
               mm: Mm = f32_mm) -> Tuple[float, float]:
    """(validation loss, RMSE of the median level) on the rows `valid`
    (n, 5), weighted, in one chunk as a fit of this size takes it."""
    dev = params["mlp.out.b"].device
    rows = torch.as_tensor(valid, device=dev)
    q = torch.tensor([float(x) for x in cfg["quantile_levels"]],
                     dtype=torch.float32, device=dev)
    with torch.no_grad():
        pred = net.forward(params, consts, rows[:, 0:2], rows[:, 2:3], None,
                           mm)
        w = rows[:, 4]
        loss = check_loss(pred, rows[:, 3:4], w, q)
        mid = len(cfg["quantile_levels"]) // 2
        se = torch.sum((pred[:, mid:mid + 1] - rows[:, 3:4]) ** 2
                       * w[:, None])
        rmse = torch.sqrt(se / torch.clamp(torch.sum(w), min=1.0))
    return float(loss), float(rmse)


def scores(net: Net, cfg: Dict, params: Dict[str, torch.Tensor],
           consts: Dict[str, torch.Tensor], z: np.ndarray,
           coords: np.ndarray, masks: Dict[str, np.ndarray],
           mm: Mm = f32_mm) -> Dict[str, Dict[str, float]]:
    """Each split's scores of the dense field: MSE, MAE and RMSE of the
    median level, the CRPS (2 x the mean check loss over the levels) and
    the mean check loss, in float64 over the split's finite points."""
    from stbench.reference.data import grid
    dev = params["mlp.out.b"].device
    gc, gt = grid(z, coords)
    pred = net.predict(params, consts, torch.as_tensor(gc, device=dev),
                       torch.as_tensor(gt, device=dev), mm=mm)
    pred = pred.double().cpu().numpy()
    zz = z.ravel().astype(np.float64)
    q = np.asarray(cfg["quantile_levels"], np.float64)
    mid = len(q) // 2
    out = {}
    for split, mask in masks.items():
        m = mask.ravel() & np.isfinite(zz)
        p, y = pred[m], zz[m]
        err = p[:, mid] - y
        e_k = y[:, None] - p
        check = np.mean(np.maximum((q - 1.0) * e_k, q * e_k), axis=0)
        mse = float(np.mean(err * err))
        out[split] = {"mse": mse, "mae": float(np.mean(np.abs(err))),
                      "rmse": math.sqrt(mse),
                      "crps": 2.0 * float(check.mean()),
                      "mean_check_loss": float(check.mean())}
    return out


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference leaf's norm and the median leaf's."""
    norms = {n: float(torch.linalg.vector_norm(ref[n].double()))
             for n in names}
    if not names:
        return {}
    med = float(np.median(list(norms.values())))
    return {n: abs(float(torch.linalg.vector_norm(prog[n].double()))
                   - norms[n]) / max(norms[n], med, 1e-30) for n in names}


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             names: Sequence[str]) -> Tuple[float, str]:
    """The worst leaf's gap (`leaf_gaps`): (gap, leaf)."""
    gaps = leaf_gaps(prog, ref, names)
    if not gaps:
        return 0.0, ""
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def median_leaf_gap(prog: Dict[str, torch.Tensor],
                    ref: Dict[str, torch.Tensor],
                    names: Sequence[str]) -> float:
    """The median leaf's gap (`leaf_gaps`)."""
    gaps = leaf_gaps(prog, ref, names)
    return float(np.median(list(gaps.values()))) if gaps else 0.0

