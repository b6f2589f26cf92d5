"""Tensor parallelism over the basis axis on torch.distributed (port of
`st_dadk_tpu/parallel/tensor_parallel.py`).

The k spatial centers split across the ranks: rank r holds centers_r,
log-bandwidths_r and the first layer's spatial rows W_s,r (k_pad / n rows
each, k padded to a multiple of n), and runs the port's fused forward kernel
on them (`ops.fused_first_layer`, the function of `_fused_kernel`):

    partial_r = phi(coords; centers_r) @ W_s,r                   (N, H)
    h1 = sum_r (partial_r + (psi(t) @ W_t + b) / n)               the exact h1

The backward runs the port's dW and d-centers kernels on the rank's shard.
The sum is `_CrossRankSum`, an autograd Function whose backward hands the
replicated dh back unchanged: every rank holds the same dh, so a backward
that summed it again (`torch.distributed.nn.functional.all_reduce`'s) would
give the sharded leaves n times their gradient. The replicated term enters
as its share rep / n (`_ReplicatedShare`), whose backward passes dh whole:
the gradient of a replicated leaf is the sum of its n ranks' shares, as
JAX's shard_map transposes a replicated input. The rest of the network
runs replicated on every rank, and dropout acts after the sum, drawn from
the same generator on every rank: the masks are the unsharded fit's bit for
bit (JAX `:166-186`).

Pad centers sit at 0.5 with bandwidth 1.0 and zero rows of W_s: they add
nothing to the forward, but phi at a pad center is not zero, so their rows
of dW are; the training step masks the pad rows' gradients and pins their
parameters after each AdamW update (decoupled weight decay would move them
otherwise; JAX `:305-341`). Sharded-leaf penalties (domain, movement,
spatial sparsity; JAX `_tp_penalties`) sum each rank's rows through the same
cross-rank sum, and so does the gradient clip's norm. Covariates and
`early_stop_min_rel_delta` raise, as in JAX (`:47-48`, `:541-549`).

Parameters carry the JAX TP layout's names (`mlp.w0_spatial`,
`mlp.w0_temporal`, `mlp.b0`, the other layers as in `STInterp`,
`basis.{centers,log_bandwidths}`): `to_tp_params` / `from_tp_params` map
JAX-layout numpy trees to and from it, and `models.st_interp.
from_jax_params(..., tp=(rank, n))` builds a rank's `TPModel` from JAX's
`to_tp_params` output.
"""
from __future__ import annotations

import copy
import math
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from st_dadk_tpu_torch.models.st_interp import (ModelSpec, STInterp, _Linear,
                                                _LayerNorm, lane_tree,
                                                sparsity_block)
from st_dadk_tpu_torch.ops.basis import (temporal_basis_embed,
                                         temporal_grid_centers)
from st_dadk_tpu_torch.ops.fused_first_layer import fused_spatial_first_layer
from st_dadk_tpu_torch.parallel.data_parallel import DPGroup

Params = Dict[str, Any]
SHARDED = ("mlp.w0_spatial", "basis.centers", "basis.log_bandwidths")


class _CrossRankSum(torch.autograd.Function):
    """Sum over the ranks forward; identity backward (module docstring)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, tp: DPGroup) -> torch.Tensor:
        return tp.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def cross_rank_sum(x: torch.Tensor, tp: DPGroup) -> torch.Tensor:
    return _CrossRankSum.apply(x, tp) if tp.joined else x


class _ReplicatedShare(torch.autograd.Function):
    """x / n forward; g backward. Each rank adds its share x / n of a
    replicated term into the cross-rank sum; the term's gradient is the sum
    over the ranks of their shares' gradients, g / n each, which is g."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, n: int) -> torch.Tensor:
        return x / n

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def padded_k(k: int, n: int) -> int:
    return -(-k // n) * n


def to_tp_params(spec: ModelSpec, params: Params, consts: Dict[str, Any],
                 n_dev: int) -> Tuple[Params, Dict[str, Any]]:
    """A JAX-layout (params, consts) pair in the TP layout with k padded to
    a multiple of n_dev (numpy; JAX `to_tp_params`): pad centers 0.5, pad
    bandwidths 1.0 (log 0), zero rows of w0_spatial."""
    if spec.p != 0:
        raise NotImplementedError("TP basis sharding requires p_covariates=0")
    k, k_t = spec.k_spatial, spec.k_temporal
    pad = padded_k(k, n_dev) - k

    def pad_rows(x, value=0.0):
        x = np.asarray(x, np.float32)
        if pad == 0:
            return x.copy()
        fill = np.full((pad,) + x.shape[1:], value, np.float32)
        return np.concatenate([x, fill])

    tp_consts = {
        "spatial_centers_init": pad_rows(consts["spatial_centers_init"], 0.5),
        "spatial_bandwidths_init": pad_rows(consts["spatial_bandwidths_init"],
                                            1.0),
        "temporal_centers": np.asarray(consts["temporal_centers"], np.float32),
        "temporal_bandwidths": np.asarray(consts["temporal_bandwidths"],
                                          np.float32),
    }
    mlp = params["mlp"]
    w0 = np.asarray(mlp["linear_0"]["w"], np.float32)
    tp_mlp: Params = {"w0_spatial": pad_rows(w0[:k]),
                      "w0_temporal": w0[k:k + k_t].copy(),
                      "b0": np.asarray(mlp["linear_0"]["b"], np.float32)}
    for name, leaf in mlp.items():
        if name != "linear_0":
            tp_mlp[name] = _np_tree(leaf)
    tp_params: Params = {"mlp": tp_mlp}
    if spec.spatial_learnable:
        tp_params["basis"] = {
            "centers": pad_rows(params["basis"]["centers"], 0.5),
            "log_bandwidths": pad_rows(params["basis"]["log_bandwidths"], 0.0),
        }
    return tp_params, tp_consts


def from_tp_params(spec: ModelSpec, tp_params: Params) -> Params:
    """Invert `to_tp_params`: strip the pad rows, reassemble linear_0."""
    k = spec.k_spatial
    mlp_tp = tp_params["mlp"]
    w0 = np.concatenate([np.asarray(mlp_tp["w0_spatial"])[:k],
                         np.asarray(mlp_tp["w0_temporal"])], axis=0)
    mlp: Params = {"linear_0": {"w": w0, "b": np.asarray(mlp_tp["b0"])}}
    for name, leaf in mlp_tp.items():
        if name not in ("w0_spatial", "w0_temporal", "b0"):
            mlp[name] = leaf
    out: Params = {"mlp": mlp}
    if spec.spatial_learnable:
        out["basis"] = {
            "centers": np.asarray(tp_params["basis"]["centers"])[:k],
            "log_bandwidths":
                np.asarray(tp_params["basis"]["log_bandwidths"])[:k]}
    return out


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree, np.float32)


def _flat(tree: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


class TPModel(nn.Module):
    """Rank `tp.rank`'s shard of an STInterp in the TP layout (module
    docstring). The forward, trunk and head are STInterp's with the first
    layer summed across the ranks; the penalties sum the sharded rows."""

    trunk_from_h1 = STInterp.trunk_from_h1
    head = STInterp.head
    draw_dropout_keep = STInterp.draw_dropout_keep
    _dropout_masks = STInterp._dropout_masks
    _split_keep = STInterp._split_keep

    def __init__(self, spec: ModelSpec, tp_params: Params,
                 tp_consts: Dict[str, Any], tp: DPGroup):
        super().__init__()
        if spec.p != 0:
            raise NotImplementedError("TP basis sharding requires "
                                      "p_covariates=0")
        if not spec.hidden_dims:
            raise ValueError("TP shards the first hidden layer; this model "
                             "has none")
        self.spec, self.tp = spec, tp
        k_pad = np.asarray(tp_params["mlp"]["w0_spatial"]).shape[0]
        if k_pad % tp.world:
            raise ValueError(f"k_pad={k_pad} does not split over "
                             f"{tp.world} ranks")
        k_loc = k_pad // tp.world
        rows = slice(tp.rank * k_loc, (tp.rank + 1) * k_loc)
        self.rows = rows
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
        self.register_buffer("spatial_centers_init",
                             f32(tp_consts["spatial_centers_init"])[rows])
        self.register_buffer("spatial_bandwidths_init",
                             f32(tp_consts["spatial_bandwidths_init"])[rows])
        t_centers, t_bw = temporal_grid_centers(spec.k_temporal_centers)
        self.register_buffer("temporal_centers", f32(
            tp_consts.get("temporal_centers", t_centers)))
        self.register_buffer("temporal_bandwidths", f32(
            tp_consts.get("temporal_bandwidths", t_bw)))
        self.register_buffer("row_valid", torch.arange(
            rows.start, rows.stop) < spec.k_spatial)
        if spec.spatial_learnable:
            self.basis = nn.Module()
            self.basis.centers = nn.Parameter(
                f32(tp_params["basis"]["centers"])[rows].clone())
            self.basis.log_bandwidths = nn.Parameter(
                f32(tp_params["basis"]["log_bandwidths"])[rows].clone())
        self.mlp = nn.Module()
        h = spec.hidden_dims
        self.mlp.w0_spatial = nn.Parameter(
            f32(tp_params["mlp"]["w0_spatial"])[rows].clone())
        self.mlp.w0_temporal = nn.Parameter(f32(tp_params["mlp"]["w0_temporal"]))
        self.mlp.b0 = nn.Parameter(f32(tp_params["mlp"]["b0"]))
        prev = h[0]
        for i, hdim in enumerate(h):
            if i > 0:
                setattr(self.mlp, f"linear_{i}", _Linear(prev, hdim))
            if spec.layernorm:
                setattr(self.mlp, f"ln_{i}", _LayerNorm(hdim))
            prev = hdim
        if spec.delta_head:
            self.mlp.delta = nn.Parameter(torch.zeros(spec.output_dim,
                                                      prev + 1))
        else:
            self.mlp.out = _Linear(prev, spec.output_dim)
        flat = _flat(tp_params)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name not in SHARDED:
                    p.copy_(f32(flat[name]))

    def clone(self) -> "TPModel":
        """A copy on the same device and group (the EMA model)."""
        other = TPModel.__new__(TPModel)
        nn.Module.__init__(other)
        other.spec, other.tp, other.rows = self.spec, self.tp, self.rows
        for name, b in self.named_buffers(recurse=False):
            other.register_buffer(name, b.clone())
        for name, mod in self.named_children():
            setattr(other, name, copy.deepcopy(mod))
        return other

    def spatial_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.spec.spatial_learnable:
            return self.basis.centers, torch.exp(self.basis.log_bandwidths)
        return self.spatial_centers_init, self.spatial_bandwidths_init

    def forward(self, coords: torch.Tensor, t: torch.Tensor,
                X: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                fused: Optional[bool] = None,
                dropout_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """yhat (B, output_dim), replicated on every rank."""
        if X is not None:
            raise NotImplementedError("TP takes no covariates")
        return self.head(self.trunk_from_h1(self.first_layer(coords, t),
                                            train, generator, dropout_keep))

    def first_layer(self, coords: torch.Tensor, t: torch.Tensor
                    ) -> torch.Tensor:
        centers, bandwidths = self.spatial_params()
        partial = fused_spatial_first_layer(coords, centers, bandwidths,
                                            self.mlp.w0_spatial,
                                            self.spec.spatial_basis_function)
        psi = temporal_basis_embed(t, self.temporal_centers,
                                   self.temporal_bandwidths)
        rep = psi @ self.mlp.w0_temporal + self.mlp.b0
        return cross_rank_sum(
            partial + _ReplicatedShare.apply(rep, self.tp.world), self.tp)

    # -- penalties (JAX `_tp_penalties`: sharded rows sum across ranks) ------
    def domain_penalty(self, bounds: Tuple[float, float] = (0.0, 1.0)
                       ) -> torch.Tensor:
        c = self.basis.centers
        lo, hi = bounds
        return cross_rank_sum(torch.sum(
            (torch.relu(lo - c) + torch.relu(c - hi)) ** 2), self.tp)

    def movement_penalty(self) -> torch.Tensor:
        return cross_rank_sum(torch.sum(
            (self.basis.centers - self.spatial_centers_init) ** 2), self.tp)

    def sparsity_penalty(self, penalty_type: str, lambda_l1: float,
                         lambda_group: float) -> Dict[str, torch.Tensor]:
        if penalty_type == "none":
            zero = self.mlp.b0.new_zeros(())
            return {"spatial_penalty": zero, "temporal_penalty": zero,
                    "total_penalty": zero}
        if penalty_type not in ("element", "group", "sparse_group"):
            raise ValueError(f"Unknown penalty_type: {penalty_type}")
        sp = cross_rank_sum(sparsity_block(self.mlp.w0_spatial, penalty_type,
                                           lambda_l1, lambda_group), self.tp)
        tp = sparsity_block(self.mlp.w0_temporal, penalty_type, lambda_l1,
                            lambda_group)
        return {"spatial_penalty": sp, "temporal_penalty": tp,
                "total_penalty": sp + tp}

    # -- the pad rows ---------------------------------------------------------
    def sharded(self) -> Dict[str, torch.Tensor]:
        return {n: p for n, p in self.named_parameters() if n in SHARDED}

    @torch.no_grad()
    def mask_pad_grads_(self) -> None:
        for p in self.sharded().values():
            if p.grad is not None:
                p.grad.mul_(_rows_like(self.row_valid, p.grad))

    @torch.no_grad()
    def pad_values(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().clone() for n, p in self.sharded().items()}

    @torch.no_grad()
    def pin_pads_(self, prev: Dict[str, torch.Tensor]) -> None:
        for n, p in self.sharded().items():
            p.copy_(torch.where(_rows_like(self.row_valid, p).bool(), p,
                                prev[n]))

    def gathered(self) -> Params:
        """The whole TP-layout tree (numpy): the sharded rows of every rank
        placed into zeros and summed across the ranks, which adds zeros
        only."""
        out = {}
        for name, p in self.named_parameters():
            x = p.detach()
            if name in SHARDED:
                full = x.new_zeros((x.shape[0] * self.tp.world,)
                                   + tuple(x.shape[1:]))
                full[self.rows] = x
                x = self.tp.all_reduce_(full)
            out[name] = x.cpu().numpy().copy()
        return lane_tree(out)


def _rows_like(valid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return valid.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


def tp_model(spec: ModelSpec, tp_params: Params, tp_consts: Dict[str, Any],
             tp: DPGroup) -> TPModel:
    """Rank tp.rank's TPModel of a whole TP-layout (params, consts) pair,
    on tp.device."""
    return TPModel(spec, tp_params, tp_consts, tp).to(tp.device)


def _group(mesh, axis: str, device) -> DPGroup:
    return (DPGroup.default(device) if mesh is None
            else DPGroup.from_mesh(mesh, device, axis))


def make_tp_forward(spec: ModelSpec, mesh=None, axis: str = "tp",
                    device: torch.device | str = "cuda"):
    """forward(tp_params, tp_consts, coords, t) -> (N, out) numpy,
    replicated, with the basis axis split over the ranks of `mesh[axis]`
    (default: every rank of the group); coords and t are numpy or tensors
    (JAX `make_tp_forward`)."""
    tp = _group(mesh, axis, device)

    @torch.no_grad()
    def forward(tp_params: Params, tp_consts: Dict[str, Any], coords, t):
        model = tp_model(spec, tp_params, tp_consts, tp)
        c = torch.as_tensor(np.asarray(coords, np.float32), device=tp.device)
        tt = torch.as_tensor(np.asarray(t, np.float32).reshape(-1, 1),
                             device=tp.device)
        return model(c, tt, train=False).cpu().numpy()

    return forward


def clip_tp_(groups: Dict[str, list], model: TPModel, grad_clip: float
             ) -> None:
    """Per-group global-norm clipping (basis at 0.1x), the sharded leaves'
    squared sums summed across the ranks in one all_reduce."""
    sharded = {id(p) for p in model.sharded().values()}
    parts, rep = [], []
    for g in ("basis", "mlp"):
        ps = groups.get(g, [])
        sh = [torch.sum(p.grad * p.grad) for p in ps if id(p) in sharded]
        rp = [torch.sum(p.grad * p.grad) for p in ps if id(p) not in sharded]
        zero = model.mlp.b0.new_zeros(())
        parts.append(sum(sh) if sh else zero)
        rep.append(sum(rp) if rp else zero)
    sq = model.tp.all_reduce_(torch.stack(parts)) + torch.stack(rep)
    for i, (g, max_norm) in enumerate((("basis", grad_clip * 0.1),
                                       ("mlp", grad_clip))):
        if g not in groups:
            continue
        scale = torch.clamp(max_norm / (torch.sqrt(sq[i]) + 1e-6), max=1.0)
        for p in groups[g]:
            p.grad.mul_(scale)


def make_tp_train_step(spec: ModelSpec, mesh=None, axis: str = "tp",
                       regression: str = "mean", quantile_levels=None,
                       domain_penalty_weight: float = 0.0,
                       weight_decay: float = 0.0,
                       device: torch.device | str = "cuda"):
    """A TP train step (JAX `make_tp_train_step`): the batch replicated,
    the basis axis split; objective = data loss + the optional domain
    penalty only. step(model, opt, coords, t, y, w, lrs, generator) ->
    loss (float); `opt` a `train.optimizer.AdamW` over the model's groups;
    the gradients stay in `.grad` (pad rows masked)."""
    from st_dadk_tpu_torch.ops.losses import (mse_loss, multi_quantile_loss,
                                              quantile_loss)
    _group(mesh, axis, device)      # the ranks must form the axis

    def data_loss(preds, y, w):
        if regression == "multi-quantile":
            q = torch.tensor(quantile_levels, dtype=torch.float32,
                             device=preds.device)
            return multi_quantile_loss(preds, y, q, w)
        if regression == "quantile":
            tau = float(quantile_levels[0]) if quantile_levels else 0.5
            return quantile_loss(preds, y, tau, w)
        return mse_loss(preds, y, w)

    def step(model: TPModel, opt, coords, t, y, w, lrs,
             generator: Optional[torch.Generator] = None) -> float:
        for p in model.parameters():
            p.grad = None
        preds = model(coords, t, train=generator is not None,
                      generator=generator)
        loss = data_loss(preds, y, w)
        if spec.spatial_learnable and domain_penalty_weight > 0:
            loss = loss + domain_penalty_weight * model.domain_penalty()
        loss.backward()
        model.mask_pad_grads_()
        prev = model.pad_values()
        opt.weight_decay = weight_decay
        opt.step(lrs)
        model.pin_pads_(prev)
        return float(loss.detach())

    return step


def fit_tp(cfg, spec_model: ModelSpec, params: Params,
           consts: Dict[str, Any], train_ps, valid_ps, seed: int,
           mesh=None, axis: str = "tp",
           device: Optional[torch.device | str] = None,
           verbose: bool = False, state_out: Optional[dict] = None):
    """The full fit with the basis axis split over the ranks of
    `mesh[axis]` (default: every rank of the joined group, or this process
    alone), on `device` (default: the rank's, else the config's). The loop
    is `train.loop.fit`'s: the same generator draws the same shuffle and
    masks, AdamW with the LR tables, damping, clipping, the EMA,
    validation on the EMA, best-EMA and patience. Returns a
    `train.loop.FitResult` whose params are unsharded (`from_tp_params`),
    the same on every rank; `state_out`, when given, receives the rank's
    final 'model' and 'ema' TPModels (JAX `fit_tp`, `:530-606`)."""
    from st_dadk_tpu_torch.config import resolve_device
    from st_dadk_tpu_torch.parallel.multihost import local_device
    from st_dadk_tpu_torch.train.loop import (FitResult, LoopSpec,
                                              _damp_centers, _validate,
                                              adaptive_batch_size,
                                              epoch_batch_indices,
                                              prepare_train_data,
                                              training_loss)
    from st_dadk_tpu_torch.train.optimizer import (AdamW, build_lr_tables,
                                                   ema_update)
    if getattr(cfg, "early_stop_min_rel_delta", 0.0):
        raise NotImplementedError(
            "early_stop_min_rel_delta (plateau-slope stop) is not "
            "implemented for the tensor-parallel fit; set it to 0")
    dev = resolve_device(device or local_device() or cfg.device)
    tp = _group(mesh, axis, dev)
    batch_size = adaptive_batch_size(train_ps.n_real, cfg.batch_size)
    data, B, val_chunk = prepare_train_data(train_ps, valid_ps, batch_size,
                                            dev)
    spec = LoopSpec.from_config(cfg, spec_model, batch_size, B, val_chunk,
                                data.va_coords.shape[0] // val_chunk)
    lr_mlp, lr_basis, lr_recorded = build_lr_tables(cfg, B)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    tp_params, tp_consts = to_tp_params(spec_model, params, consts, tp.world)
    model = tp_model(spec_model, tp_params, tp_consts, tp)
    ema_model = model.clone()
    for p in ema_model.parameters():
        p.requires_grad_(False)
    groups = {"mlp": list(model.mlp.parameters())}
    if spec_model.spatial_learnable:
        groups["basis"] = list(model.basis.parameters())
    opt = AdamW(groups, spec.weight_decay)
    params_l = list(model.parameters())
    ema = list(ema_model.parameters())
    best_ema = [p.detach().clone() for p in ema]

    best_val, has_best, patience_ctr, stopped, stop_epoch = \
        math.inf, False, 0, False, 0
    hist: Dict[str, list] = {"train_loss": [], "val_loss": [],
                             "val_rmse": []}
    cap = data.tr_coords.shape[0]
    packed_tr = torch.cat([data.tr_coords, data.tr_t, data.tr_y,
                           data.tr_w[:, None]], dim=1)

    def tp_epoch(epoch: int) -> Tuple[float, float, float]:
        """One epoch's steps, then validation on the EMA (JAX
        `make_tp_epoch`)."""
        idx = epoch_batch_indices(cap, batch_size, B, spec.shuffle, gen, dev)
        batches = packed_tr[idx]
        loss_sum, nan_epoch = 0.0, False
        for b in range(B):
            xb = batches[b]
            for p in params_l:
                p.grad = None
            loss = training_loss(spec, model, xb[:, 0:2], xb[:, 2:3],
                                 xb[:, 3:4], xb[:, 4], train=True,
                                 generator=gen)
            loss.backward()
            model.mask_pad_grads_()
            _damp_centers(spec, model, False)
            if spec.grad_clip > 0:
                clip_tp_(groups, model, spec.grad_clip)
            prev = model.pad_values()
            s = epoch * B + b
            opt.step({"mlp": float(lr_mlp[s]), "basis": float(lr_basis[s])})
            model.pin_pads_(prev)
            ema_update(ema, params_l, data.ema_decay)
            lv = float(loss.detach())
            loss_sum += lv
            if not math.isfinite(lv):
                nan_epoch = True
                break
        train_loss = math.nan if nan_epoch else loss_sum / max(B, 1)
        if spec.ablate_validate:
            return train_loss, train_loss, 0.0
        val = torch.tensor(_validate(spec, ema_model, data),
                           dtype=torch.float64, device=dev)
        vl, vr = tp.broadcast_(val).tolist()     # one stop flag for all
        return train_loss, vl, vr

    t_loop = time.perf_counter()
    for epoch in range(int(cfg.epochs)):
        train_loss, val_loss, val_rmse = tp_epoch(epoch)
        if math.isfinite(val_loss) and val_loss < best_val:
            best_val, has_best, patience_ctr = val_loss, True, 0
            with torch.no_grad():
                for dst, src in zip(best_ema, ema):
                    dst.copy_(src)
        else:
            patience_ctr += 1
        hist["train_loss"].append(train_loss)
        hist["val_loss"].append(val_loss)
        hist["val_rmse"].append(val_rmse)
        if verbose:
            print(f"  [fit_tp] epoch {epoch + 1:4d} train {train_loss:.6f} "
                  f"val {val_loss:.6f}", flush=True)
        if patience_ctr >= spec.patience:
            stopped, stop_epoch = True, epoch + 1
            break
    t_epochs = time.perf_counter() - t_loop
    n_run = stop_epoch if stopped else len(hist["train_loss"])

    final_ema = from_tp_params(spec_model, ema_model.gathered())
    if has_best:
        with torch.no_grad():
            for dst, src in zip(ema, best_ema):
                dst.copy_(src)
    serving = from_tp_params(spec_model, ema_model.gathered())
    if state_out is not None:
        state_out.update(model=model, ema=ema_model)
    history = {k: np.asarray(v[:n_run], np.float64) for k, v in hist.items()}
    history["lr"] = lr_recorded[:n_run].copy()
    return FitResult(
        params=serving, history=history, best_val=float(best_val),
        n_epochs_run=n_run, stopped_early=stopped,
        center_shift=np.zeros(0), n_steps=opt.step_count,
        n_val_chunks=spec.n_val_chunks,
        timings={"epochs_seconds": t_epochs},
        final_ema=final_ema)
