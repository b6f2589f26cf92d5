"""The training loop (port of `st_dadk_tpu/train/loop.py`, single fit).

The JAX package compiles the whole fit into one scanned program; here it is
an eager loop over epochs and minibatches with the same semantics:

  - per-epoch shuffle of the padded training buffer (cap = B * batch points,
    padding weight 0), B = ceil(n/batch) steps, ragged last batch weighted;
  - AdamW with per-step LRs for the MLP and basis groups read from the LR
    tables; center-gradient damping, then per-group clipping (basis 0.1x);
  - EMA after every step, decay 1 - 1/(10 B); validation on the EMA weights
    in chunks of min(max(16 batch, 32768), n_valid);
  - best-EMA checkpoint, early stopping (patience, optional plateau margin);
  - a NaN loss poisons its step (the update still applies, as in the
    reference) and skips the rest of the epoch;
  - `ablate_validate: true` (JAX loop.py:550-551): the epoch's train loss
    stands in for the validation loss and the validation RMSE is 0;
  - with `checkpoint_path`, the whole loop state goes to an npz file every
    `epochs_chunk` epochs, and `resume=True` continues from it bit for bit
    (`save_fit_checkpoint` / `load_fit_checkpoint`, JAX loop.py:1151-1290).

Shuffle (`extra['shuffle']`, JAX `epoch_batch_indices`, loop.py:381-413):
'auto' (the default) and 'hash' permute the epoch's capacity by the keyed
multiply-xorshift bijection of `hash_permutation_any` wherever the lanes
are uniform (a single fit always is), 'perm' draws `torch.randperm`, and
'none' keeps the identity order. The bijection's four multipliers are drawn
from the fit's generator once an epoch (`hash_multipliers`); fed JAX's
multipliers, the permutation is JAX's bit for bit. The generators do not
cross frameworks, so the two packages agree on batch order only where the
multipliers are handed across or under 'none', and on dropout masks only
at dropout 0.

`fit_lanes` runs M such fits of one spec as lanes of one eager program
(JAX `_run_epoch` / `_epoch_bookkeeping` under vmap): every op serves all
lanes, the NaN flag, the loss sum and the early-stopping state stay on the
device, and the host reads one flag an epoch (all lanes stopped). Each lane
shuffles from its own generator seeded with its experiment seed: uniform
lanes by the bijection with the lane's own multipliers, all lanes in one
set of elementwise ops; lanes of different batch counts by a permutation
of their own capacity. Dropout masks for all lanes come from one generator
of the batch in
one draw, so a lane's dropout stream differs from its sequential fit's: a
lane and its single fit agree closely only at dropout 0 under
`shuffle: none`, and statistically otherwise.

`packed_optimizer: true` runs the optimizer step, the EMA and the best-EMA
copy on one flat buffer a parameter group (`train/packing.py`), in `fit`
and `fit_lanes`: the parameters and their gradients are views into the
buffers, and the results are bitwise the per-leaf step's but for the clip's
norm, which sums in another order. `tail_compaction: true` narrows a lane
batch once to its active lanes (`fit_lanes`, JAX batch_engine.py:906-1030).

`regression_type: quantile` is one model of one tau (`current_quantile`)
trained on the check loss, which also drives validation and early
stopping. Lanes of one tau take it as a float, as the single fit does;
lanes of different taus (the per-tau fits of a batch) take each its own
from a (M,) tensor, `fit_lanes(taus=...)`.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.dataio.arrays import PointSet, pad_pointset
from st_dadk_tpu_torch.models.st_interp import (ModelSpec, STInterp,
                                                STInterpLanes, lane_tree,
                                                load_jax_params, select_lanes,
                                                to_jax_params)
from st_dadk_tpu_torch.ops.losses import (mse_loss, mse_loss_lanes,
                                          multi_quantile_loss,
                                          multi_quantile_loss_lanes,
                                          non_crossing_penalty,
                                          non_crossing_penalty_lanes,
                                          p_nc_delta_penalty,
                                          p_nc_delta_penalty_lanes,
                                          quantile_loss, quantile_loss_lanes)
from st_dadk_tpu_torch.parallel.data_parallel import (DPGroup,
                                                      block_wsum_total,
                                                      loss_share,
                                                      sync_gradients_,
                                                      sync_lane_gradients_,
                                                      validation_sums)
from st_dadk_tpu_torch.train.optimizer import (AdamW, AdamWLanes,
                                               build_lr_tables,
                                               clip_by_global_norm_,
                                               clip_by_global_norm_lanes_,
                                               ema_update, ema_update_lanes,
                                               gradient_damping)
from st_dadk_tpu_torch.train.packing import PackSpec
from st_dadk_tpu_torch.utils import trace


@dataclass(frozen=True)
class LoopSpec:
    """Training-loop configuration."""
    model: ModelSpec
    regression_type: str = "mean"
    quantile_levels: Tuple[float, ...] = (0.1, 0.5, 0.9)
    current_quantile: Optional[float] = None
    non_crossing_weight: float = 0.0
    non_crossing_power: int = 1
    non_crossing_lambda: float = 0.0
    non_crossing_delta_mode: str = "eq310"
    domain_penalty_weight: float = 0.0
    movement_penalty_weight: float = 0.0
    sparsity_penalty_type: str = "none"
    sparsity_lambda_l1: float = 0.001
    sparsity_lambda_group: float = 0.01
    sparsity_apply_to_spatial: bool = True
    sparsity_apply_to_temporal: bool = True
    gradient_damping: bool = False
    damping_threshold: float = 0.3
    damping_strength: float = 1.0
    grad_clip: float = 0.0
    weight_decay: float = 1e-5
    batch_size: int = 256
    n_batches: int = 1
    epochs: int = 100
    patience: int = 15
    min_rel_delta: float = 0.0
    val_chunk: int = 32768
    n_val_chunks: int = 1
    record_centers: bool = False
    shuffle: str = "auto"
    ablate_validate: bool = False

    @classmethod
    def from_config(cls, cfg: ExperimentConfig, model: ModelSpec,
                    batch_size: int, n_batches: int, val_chunk: int,
                    n_val_chunks: int) -> "LoopSpec":
        return cls(
            model=model,
            regression_type=cfg.regression_type,
            quantile_levels=tuple(cfg.quantile_levels),
            current_quantile=cfg.current_quantile,
            non_crossing_weight=cfg.non_crossing_weight,
            non_crossing_power=cfg.non_crossing_power,
            non_crossing_lambda=cfg.non_crossing_lambda,
            non_crossing_delta_mode=cfg.non_crossing_delta_mode,
            domain_penalty_weight=cfg.domain_penalty_weight,
            movement_penalty_weight=cfg.movement_penalty_weight,
            sparsity_penalty_type=cfg.sparsity_penalty_type,
            sparsity_lambda_l1=cfg.sparsity_lambda_l1,
            sparsity_lambda_group=cfg.sparsity_lambda_group,
            sparsity_apply_to_spatial=cfg.sparsity_apply_to_spatial,
            sparsity_apply_to_temporal=cfg.sparsity_apply_to_temporal,
            gradient_damping=cfg.gradient_damping,
            damping_threshold=cfg.damping_threshold,
            damping_strength=cfg.damping_strength,
            grad_clip=cfg.grad_clip,
            weight_decay=cfg.weight_decay,
            batch_size=batch_size,
            n_batches=n_batches,
            epochs=cfg.epochs,
            patience=cfg.patience,
            min_rel_delta=cfg.early_stop_min_rel_delta,
            val_chunk=val_chunk,
            n_val_chunks=n_val_chunks,
            record_centers=cfg.spatial_learnable,
            shuffle=_shuffle_mode(cfg),
            ablate_validate=bool(cfg.extra.get("ablate_validate", False)),
        )


SHUFFLES = ("auto", "hash", "perm", "none")
# epochs between the centers kept for the basis-evolution figure (JAX
# assemble_result, loop.py:1318-1320)
CENTERS_EVERY = 100


def _shuffle_mode(cfg: ExperimentConfig) -> str:
    mode = str(cfg.extra.get("shuffle", "auto"))
    if mode not in SHUFFLES:
        raise ValueError(f"shuffle must be one of {SHUFFLES}, got {mode!r}")
    return mode


class TrainData(NamedTuple):
    """Padded training and validation buffers on the fit's device."""
    tr_coords: torch.Tensor   # (cap_tr, 2)
    tr_t: torch.Tensor        # (cap_tr, 1)
    tr_y: torch.Tensor        # (cap_tr, 1)
    tr_w: torch.Tensor        # (cap_tr,)
    va_coords: torch.Tensor   # (cap_va, 2)
    va_t: torch.Tensor
    va_y: torch.Tensor
    va_w: torch.Tensor
    ema_decay: float


# ---------------------------------------------------------------------------
# Loss assembly
# ---------------------------------------------------------------------------

def training_loss(spec: LoopSpec, model: STInterp, coords: torch.Tensor,
                  t: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                  train: bool, generator: Optional[torch.Generator],
                  dropout_keep: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Composite objective: main loss plus the enabled penalties
    (`dropout_keep`: a keep mask drawn by the caller, `STInterp.forward`)."""
    preds = model(coords, t, train=train, generator=generator,
                  dropout_keep=dropout_keep)
    return loss_from_preds(spec, model, preds, y, w, train)


def loss_from_preds(spec: LoopSpec, model: STInterp, preds: torch.Tensor,
                    y: torch.Tensor, w: torch.Tensor, train: bool
                    ) -> torch.Tensor:
    m = spec.model
    if spec.regression_type == "mean":
        loss = mse_loss(preds, y, w)
    elif spec.regression_type == "quantile":
        loss = quantile_loss(preds, y, float(spec.current_quantile), w)
    elif spec.regression_type == "multi-quantile":
        q = torch.tensor(spec.quantile_levels, dtype=torch.float32,
                         device=preds.device)
        loss = multi_quantile_loss(preds, y, q, w)
        if m.use_delta_reparameterization and m.delta_head:
            if spec.non_crossing_lambda > 0:
                p_nc = p_nc_delta_penalty(model.mlp.delta)
                if spec.non_crossing_delta_mode == "abs":
                    p_nc = -p_nc
                loss = loss + spec.non_crossing_lambda * p_nc
        elif spec.non_crossing_weight > 0:
            loss = loss + spec.non_crossing_weight * non_crossing_penalty(
                preds, "mean", spec.non_crossing_power, weights=w)
    else:
        raise ValueError(f"Unknown regression_type: {spec.regression_type}")

    if train:
        if m.spatial_learnable:
            if spec.domain_penalty_weight > 0:
                loss = loss + spec.domain_penalty_weight * model.domain_penalty()
            if spec.movement_penalty_weight > 0:
                loss = loss + (spec.movement_penalty_weight
                               * model.movement_penalty())
        if spec.sparsity_penalty_type != "none":
            pen = model.sparsity_penalty(spec.sparsity_penalty_type,
                                         spec.sparsity_lambda_l1,
                                         spec.sparsity_lambda_group)
            if spec.sparsity_apply_to_spatial:
                loss = loss + pen["spatial_penalty"]
            if spec.sparsity_apply_to_temporal:
                loss = loss + pen["temporal_penalty"]
    return loss


def _damp_centers(spec: LoopSpec, model: STInterp | STInterpLanes,
                  packed: bool) -> None:
    """Center-gradient damping, in place: a packed fit's centers gradient
    is a view of its group's buffer, which must keep it."""
    if spec.model.spatial_learnable and spec.gradient_damping:
        c = model.basis.centers
        damped = gradient_damping(c.grad, c, model.spatial_centers_init,
                                  spec.damping_threshold,
                                  spec.damping_strength)
        if packed:
            c.grad.copy_(damped)
        else:
            c.grad = damped


def _param_groups(model: STInterp | STInterpLanes
                  ) -> Dict[str, List[torch.Tensor]]:
    """The optimizer's groups of an unpacked fit: its parameters."""
    groups = {"mlp": list(model.mlp.parameters())}
    if model.spec.spatial_learnable:
        groups["basis"] = list(model.basis.parameters())
    return groups


def _transform_grads(spec: LoopSpec, model: STInterp,
                     groups: Optional[Dict[str, List[torch.Tensor]]] = None,
                     packed: bool = False) -> None:
    """In place on `.grad`: damping on centers, then per-group clipping of
    the optimizer's `groups` (default: the parameters; a packed fit's two
    buffers)."""
    groups = _param_groups(model) if groups is None else groups
    _damp_centers(spec, model, packed)
    if spec.grad_clip > 0:
        if "basis" in groups:
            clip_by_global_norm_([p.grad for p in groups["basis"]],
                                 spec.grad_clip * 0.1)
        clip_by_global_norm_([p.grad for p in groups["mlp"]], spec.grad_clip)


def _optimizer_tensors(model: STInterp | STInterpLanes,
                       ema_model: STInterp | STInterpLanes, packed: bool
                       ) -> Tuple[Dict[str, List[torch.Tensor]],
                                  List[torch.Tensor], List[torch.Tensor],
                                  Optional[PackSpec]]:
    """(the optimizer's groups, the tensors it updates, the EMA tensors in
    the same order, the packing or None). Unpacked: the parameters. Packed
    (`train/packing.py`): each group's flat buffer, whose `.grad` is the
    group's gradient buffer; the parameters of `model` and `ema_model`
    become views into them."""
    for p in ema_model.parameters():
        p.requires_grad_(False)
    if packed:
        layout = PackSpec.for_model(model)
        bufs = layout.attach(model)
        ema = layout.attach(ema_model, with_grads=False)
        return ({g: [bufs[g]] for g in layout.groups},
                [bufs[g] for g in layout.groups],
                [ema[g] for g in layout.groups], layout)
    return (_param_groups(model), list(model.parameters()),
            list(ema_model.parameters()), None)


def _zero_grads(tensors: Sequence[torch.Tensor],
                layout: Optional[PackSpec]) -> None:
    """Reset the gradients before a backward: unpacked, to None; packed,
    the gradient buffers to 0 in place (module docstring)."""
    for t in tensors:
        if layout is None:
            t.grad = None
        else:
            t.grad.zero_()


def _check_grad_views(model: torch.nn.Module, tensors: Sequence[torch.Tensor],
                      layout: Optional[PackSpec]) -> None:
    """After a packed fit's first backward: every parameter's gradient is
    still a view of its group's gradient buffer."""
    if layout is not None and not layout.grads_are_views(
            model, dict(zip(layout.groups, (t.grad for t in tensors)))):
        raise RuntimeError("a parameter's gradient left the packed "
                           "gradient buffer")


def _leaves(layout: Optional[PackSpec], tensors: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    """Per-parameter tensors (in the model's parameter order) of tensors
    parallel to the optimizer's: themselves unpacked, views of the group
    buffers packed."""
    if layout is None:
        return list(tensors)
    return list(layout.views(dict(zip(layout.groups, tensors))).values())


# ---------------------------------------------------------------------------
# Validation (EMA weights, dropout off)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _validate(spec: LoopSpec, ema: STInterp, data: TrainData,
              dp: Optional[DPGroup] = None) -> Tuple[float, float]:
    """(val_loss, val_rmse): the mean of per-chunk mean losses over chunks
    holding real points, and the RMSE of the median-quantile predictions.
    With `dp`, each rank evaluates its rows of every chunk, weighs its
    chunk loss by its share of the chunk's weight, and one all_reduce
    completes the sums (JAX's sharded `_validate`, loop.py:318-357); rank
    0's result is broadcast, so every rank reads the same stop flag."""
    C = spec.val_chunk
    losses, valid, se, cnt = [], [], [], []
    for i in range(spec.n_val_chunks):
        sl = slice(i * C, (i + 1) * C)
        ck, tk, yk, wk = (data.va_coords[sl], data.va_t[sl], data.va_y[sl],
                          data.va_w[sl])
        n_real = torch.sum(wk)
        if dp is not None:
            rows = dp.rows(wk.shape[0])
            ck, tk, yk, wk = ck[rows], tk[rows], yk[rows], wk[rows]
        preds = ema(ck, tk, train=False)
        loss = loss_from_preds(spec, ema, preds, yk, wk, train=False)
        if dp is not None:
            loss = loss * (torch.sum(wk) / torch.clamp(n_real, min=1e-12))
        if spec.regression_type == "multi-quantile":
            mid = len(spec.quantile_levels) // 2
            preds = preds[:, mid:mid + 1]
        has_real = (n_real > 0).float()
        losses.append(loss * has_real)
        valid.append(has_real)
        se.append(torch.sum((preds - yk) ** 2 * wk[:, None]))
        cnt.append(n_real)
    losses, se = torch.stack(losses), torch.stack(se)
    if dp is not None:
        losses, se = validation_sums(dp, (losses, se))
    val_loss = losses.sum() / torch.clamp(torch.stack(valid).sum(), min=1.0)
    val_rmse = torch.sqrt(se.sum()
                          / torch.clamp(torch.stack(cnt).sum(), min=1.0))
    if dp is not None:
        val_loss, val_rmse = dp.broadcast_(torch.stack([val_loss, val_rmse]))
    return float(val_loss), float(val_rmse)


# ---------------------------------------------------------------------------
# Host-side orchestration
# ---------------------------------------------------------------------------

class FitResult(NamedTuple):
    params: Dict               # serving params (best EMA, else final EMA), JAX layout
    history: Dict[str, np.ndarray]
    best_val: float
    n_epochs_run: int
    stopped_early: bool
    center_shift: np.ndarray   # per epoch: max |centers - centers_init|
    n_steps: int
    n_val_chunks: int          # validation forwards per epoch
    timings: Dict[str, float]
    final_ema: Optional[Dict] = None     # the last EMA, JAX layout
    # [(epoch, centers (k, 2))] every CENTERS_EVERY epochs, learnable basis
    centers_history: Tuple = ()


def adaptive_batch_size(n_train: int, batch_size: int,
                        min_batches: int = 10) -> int:
    """Halve the batch until there are >= min_batches batches per epoch."""
    while n_train / batch_size < min_batches and batch_size > 1:
        batch_size //= 2
    return batch_size


def prepare_train_data(train_ps: PointSet, valid_ps: PointSet,
                       batch_size: int, device: torch.device,
                       val_chunk: Optional[int] = None,
                       cap_tr: Optional[int] = None,
                       cap_va: Optional[int] = None
                       ) -> Tuple[TrainData, int, int]:
    """Pad the point sets and move them to `device`:
    (TrainData, batches per epoch, validation chunk). `cap_tr` / `cap_va`
    pad to a capacity shared with other lanes; B and the EMA decay stay the
    set's own."""
    n_tr = train_ps.n_real
    B = max(1, -(-n_tr // batch_size))
    tr = pad_pointset(train_ps, cap_tr or B * batch_size)
    n_va = max(1, valid_ps.n_real)
    vchunk = val_chunk or min(max(batch_size * 16, 32768), n_va)
    n_chunks = max(1, -(-n_va // vchunk))
    va = pad_pointset(valid_ps, cap_va or n_chunks * vchunk)
    dev = lambda a: torch.as_tensor(a, device=device)
    data = TrainData(
        tr_coords=dev(tr.coords), tr_t=dev(tr.t), tr_y=dev(tr.y),
        tr_w=dev(tr.w), va_coords=dev(va.coords), va_t=dev(va.t),
        va_y=dev(va.y), va_w=dev(va.w),
        ema_decay=float(np.float32(1.0 - 1.0 / (10.0 * B))))
    return data, B, vchunk


def hash_width(cap: int) -> int:
    """The power of two the bijection of `hash_permutation_any` runs on."""
    cap = int(cap)
    return cap if cap & (cap - 1) == 0 else 1 << cap.bit_length()


def hash_multipliers(cap: int, generator: torch.Generator,
                     device: torch.device | str) -> torch.Tensor:
    """The bijection's four random values for one epoch, (4,) int64 in
    [0, hash_width(cap)), as JAX draws them (loop.py:435-436)."""
    return torch.randint(0, hash_width(cap), (4,), generator=generator,
                         device=device)


def hash_permutation(r: torch.Tensor, cap: int) -> torch.Tensor:
    """Keyed exact permutation of [0, cap) for a power-of-two cap (JAX
    loop.py:416-441): three rounds of (odd multiply mod 2^w, xorshift
    right) after an xor with r[3], each invertible on w-bit integers. `r`
    (..., 4) int64 holds one set of values a permutation; the result is
    (..., cap) int64. JAX multiplies in uint32, which wraps mod 2^32 and so
    mod 2^w; here the product stays exact in int64 (w <= 31) and is masked
    to w bits, the same residue."""
    w = int(cap).bit_length() - 1
    mask = cap - 1
    s1, s2 = max(1, w // 2), max(1, w // 3)
    r = r.to(torch.int64)
    x = torch.arange(cap, dtype=torch.int64, device=r.device).expand(
        *r.shape[:-1], cap)
    x = x ^ (r[..., 3:4] & mask)
    for i in range(3):
        x = (x * (2 * r[..., i:i + 1] + 1)) & mask
        x = x ^ (x >> (s1 if i % 2 == 0 else s2))
    return x


def hash_permutation_any(r: torch.Tensor, cap: int) -> torch.Tensor:
    """Keyed permutation of [0, cap) for any cap (JAX loop.py:444-461): the
    bijection on hash_width(cap), restricted to [0, cap) in its order by one
    cumsum and one scatter. `r` (..., 4) as in `hash_permutation`."""
    big_n = hash_width(cap)
    if big_n == cap:
        return hash_permutation(r, cap)
    big = hash_permutation(r, big_n)
    keep = big < cap
    pos = torch.where(keep, torch.cumsum(keep, dim=-1) - 1, cap)
    out = torch.zeros((*big.shape[:-1], cap + 1), dtype=torch.int64,
                      device=big.device)
    out.scatter_(-1, pos, big)      # the dropped entries land in column cap
    return out[..., :cap]


def epoch_batch_indices(cap: int, bs: int, B: int, shuffle: str,
                        generator: torch.Generator,
                        device: torch.device) -> torch.Tensor:
    """(B, bs) point indices of one epoch of a single fit (whose lane is
    uniform): the identity order under 'none', `torch.randperm` under
    'perm', the bijection with multipliers from `generator` under 'auto'
    and 'hash'."""
    if shuffle == "none":
        return (torch.arange(B * bs, device=device) % cap).reshape(B, bs)
    if shuffle == "perm":
        perm = torch.randperm(cap, generator=generator, device=device)
    elif shuffle in ("auto", "hash"):
        perm = hash_permutation_any(
            hash_multipliers(cap, generator, device), cap)
    else:
        raise ValueError(f"shuffle must be one of {SHUFFLES}, got "
                         f"{shuffle!r}")
    return perm[:B * bs].reshape(B, bs)


# ---------------------------------------------------------------------------
# Checkpoint and resume of a single fit (JAX loop.py:1130-1190)
# ---------------------------------------------------------------------------

def _flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_tree(v, f"{prefix}{k}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_fit_checkpoint(path, carry: Dict[str, Any], epochs_done: int,
                        hists: list) -> None:
    """The whole loop state in one npz file, in the JAX package's layout:
    the carry tree flattened to dotted names (params, opt_state.{m,v,step},
    ema, best_ema, the early-stop scalars), `__epochs_done` and the
    concatenated history under `__hist.<name>`. The fit's generator state
    (`carry['generator_state']`) takes the place of JAX's PRNG key
    (`__key_data`) as `__generator_state`. Written to a temporary file and
    moved over `path`, so a crash leaves the previous checkpoint."""
    state = dict(carry)
    gen_state = state.pop("generator_state")
    flat = _flatten_tree(state)
    flat["__generator_state"] = np.asarray(gen_state, np.uint8)
    flat["__epochs_done"] = np.asarray(epochs_done)
    hist_cat = {f"__hist.{k}": np.concatenate([h[k] for h in hists])
                for k in (hists[0] if hists else {})}
    tmp = Path(str(path) + ".tmp.npz")
    np.savez(tmp, **flat, **hist_cat)
    tmp.replace(path)


def load_fit_checkpoint(path) -> Tuple[Dict[str, Any], int, list]:
    """(carry, epochs_done, [history]) of `save_fit_checkpoint`."""
    data = np.load(path, allow_pickle=False)
    flat, hist = {}, {}
    epochs_done, gen_state = 0, None
    for name in data.files:
        if name == "__generator_state":
            gen_state = data[name]
        elif name == "__epochs_done":
            epochs_done = int(data[name])
        elif name.startswith("__hist."):
            hist[name[len("__hist."):]] = data[name]
        else:
            flat[name] = data[name]
    carry = lane_tree(flat)
    carry["generator_state"] = gen_state
    return carry, epochs_done, [hist] if hist else []


def _fit_carry(model: STInterp, opt: AdamW, ema_model: STInterp,
               moments: Tuple[List[torch.Tensor], List[torch.Tensor]],
               best_ema: Sequence[torch.Tensor], book: Dict[str, Any],
               gen: torch.Generator) -> Dict[str, Any]:
    """The single fit's loop state as a JAX-layout carry of numpy arrays;
    `moments` and `best_ema` hold a tensor a parameter (`_leaves`), so a
    packed fit's checkpoint has the structured layout too."""
    names = [n for n, _ in model.named_parameters()]
    host = lambda ts: lane_tree({n: t.detach().cpu().numpy().copy()
                                 for n, t in zip(names, ts)})
    params = [p for _, p in model.named_parameters()]
    return {
        "params": host(params),
        "opt_state": {"m": host(moments[0]), "v": host(moments[1]),
                      "step": np.asarray(opt.step_count, np.int32)},
        "ema": to_jax_params(ema_model),
        "best_ema": host(best_ema),
        # float64: the host's bookkeeping, whose values the checkpoint
        # must give back exactly (JAX's carry holds float32 scalars)
        "best_val": np.asarray(book["best_val"], np.float64),
        "sig_best": np.asarray(book["sig_best"], np.float64),
        "has_best": np.asarray(book["has_best"]),
        "patience_ctr": np.asarray(book["patience_ctr"], np.int32),
        "stopped": np.asarray(book["stopped"]),
        "stop_epoch": np.asarray(book["stop_epoch"], np.int32),
        "generator_state": gen.get_state().numpy(),
    }


def _restore_fit_carry(carry: Dict[str, Any], model: STInterp, opt: AdamW,
                       ema_model: STInterp,
                       moments: Tuple[List[torch.Tensor], List[torch.Tensor]],
                       best_ema: Sequence[torch.Tensor],
                       gen: torch.Generator) -> Dict[str, Any]:
    """Load `carry` into the fit's objects in place (through the views of
    a packed fit); its early-stop bookkeeping as a dict."""
    load_jax_params(model, carry["params"])
    load_jax_params(ema_model, carry["ema"])
    m, v = _flatten_tree(carry["opt_state"]["m"]), \
        _flatten_tree(carry["opt_state"]["v"])
    best = _flatten_tree(carry["best_ema"])
    with torch.no_grad():
        for (name, _), dm, dv, dst in zip(model.named_parameters(),
                                          moments[0], moments[1], best_ema):
            dm.copy_(torch.as_tensor(m[name]))
            dv.copy_(torch.as_tensor(v[name]))
            dst.copy_(torch.as_tensor(best[name]))
    opt.step_count = int(carry["opt_state"]["step"])
    gen.set_state(torch.as_tensor(carry["generator_state"], dtype=torch.uint8))
    return {"best_val": float(carry["best_val"]),
            "sig_best": float(carry["sig_best"]),
            "has_best": bool(carry["has_best"]),
            "patience_ctr": int(carry["patience_ctr"]),
            "stopped": bool(carry["stopped"]),
            "stop_epoch": int(carry["stop_epoch"])}


def fit(cfg: ExperimentConfig, spec_model: ModelSpec, model: STInterp,
        train_ps: PointSet, valid_ps: PointSet, seed: int,
        verbose: bool = False, epochs_chunk: int = 50,
        checkpoint_path: Optional[str | Path] = None, resume: bool = False,
        session_epochs: Optional[int] = None,
        dp: Optional[DPGroup] = None) -> FitResult:
    """Train `model` in place; return the serving params and history.

    The device is the model's; shuffle and dropout draw from one generator
    on it, seeded with `seed`. With `checkpoint_path` (an `.npz` file;
    `train/checkpoint.py`), the whole loop state is written every
    `epochs_chunk` epochs, at an early stop and at the session's end;
    `resume=True` continues from it, bit for bit the uninterrupted fit on
    the same device. `session_epochs` caps the epochs this call runs (JAX
    loop.py:1192-1290). A checkpoint has the structured layout whether
    the fit is packed or not, so either resumes the other.

    With `dp` (`parallel.data_parallel.DPGroup`), the fit runs data-parallel
    over the group's ranks (JAX `fit(mesh=..., dp_axis='data')`): rank 0's
    initial model goes to every rank; every rank draws the epoch's shuffle
    and each minibatch's whole dropout block from the same generator and
    takes its own rows of both; its loss share and the gradient sum follow
    `parallel/data_parallel.py`; validation sums its ranks' shares; only
    rank 0 writes checkpoints. On one rank the fit is the single fit bit
    for bit."""
    from st_dadk_tpu_torch.train.checkpoint import (checkpoint_exists,
                                                    load_checkpoint,
                                                    save_checkpoint)
    device = next(model.parameters()).device
    batch_size = adaptive_batch_size(train_ps.n_real, cfg.batch_size)
    data, B, val_chunk = prepare_train_data(train_ps, valid_ps, batch_size,
                                            device)
    spec = LoopSpec.from_config(cfg, spec_model, batch_size, B, val_chunk,
                                data.va_coords.shape[0] // val_chunk)
    lr_mlp, lr_basis, lr_recorded = build_lr_tables(cfg, B)
    gen = torch.Generator(device=device).manual_seed(int(seed))

    if dp is not None:
        dp.broadcast_module_(model)
    use_dropout = spec_model.dropout > 0.0 and bool(spec_model.hidden_dims)
    ema_model = copy.deepcopy(model)
    groups, params, ema, layout = _optimizer_tensors(
        model, ema_model, bool(cfg.packed_optimizer))
    opt = AdamW(groups, spec.weight_decay)
    best_ema = [p.detach().clone() for p in ema]
    moments = (_leaves(layout, [opt.m[id(p)] for p in params]),
               _leaves(layout, [opt.v[id(p)] for p in params]))
    best_leaves = _leaves(layout, best_ema)

    book = {"best_val": math.inf, "sig_best": math.inf, "has_best": False,
            "patience_ctr": 0, "stopped": False, "stop_epoch": 0}
    hist: Dict[str, List[float]] = {"train_loss": [], "val_loss": [],
                                    "val_rmse": [], "center_shift": []}
    centers_history: List[Tuple[int, np.ndarray]] = []
    epochs_done = 0
    # a directory path is a DCP checkpoint (train/checkpoint.py)
    if checkpoint_path is not None and checkpoint_exists(checkpoint_path) \
            and resume:
        carry, epochs_done, hists = load_checkpoint(checkpoint_path)
        book = _restore_fit_carry(carry, model, opt, ema_model, moments,
                                  best_leaves, gen)
        for h in hists:
            for k in hist:
                hist[k] = [float(x) for x in h.get(k, [])]
            centers_history = [
                (int(e), c) for e, c in zip(h.get("centers_epochs", []),
                                            h.get("centers", []))]
        if verbose:
            print(f"Resumed training from epoch {epochs_done}")
    E = int(cfg.epochs)
    session_limit = E if session_epochs is None else \
        min(E, epochs_done + int(session_epochs))
    chunk = max(1, min(int(epochs_chunk), E))
    session_start = epochs_done

    def save():
        h = {k: np.asarray(v, np.float64) for k, v in hist.items()}
        h["centers_epochs"] = np.asarray([e for e, _ in centers_history],
                                         np.int64)
        h["centers"] = (np.stack([c for _, c in centers_history])
                        if centers_history else np.zeros((0, 0, 2),
                                                         np.float32))
        save_checkpoint(checkpoint_path,
                        _fit_carry(model, opt, ema_model, moments,
                                   best_leaves, book, gen), epochs_done, [h])

    t_steps = t_val = t_first = t_first_epoch = 0.0
    cap = data.tr_coords.shape[0]
    packed_tr = torch.cat([data.tr_coords, data.tr_t, data.tr_y,
                           data.tr_w[:, None]], dim=1)          # (cap, 5)

    t_loop = time.perf_counter()
    for epoch in range(epochs_done, session_limit):
        if book["stopped"]:
            break
        with trace.span("fit.epoch", epoch=epoch):
            t0 = time.perf_counter()
            idx = epoch_batch_indices(cap, batch_size, B, spec.shuffle, gen,
                                      device)
            batches = packed_tr[idx]                           # (B, bs, 5)
            loss_sum, nan_epoch = 0.0, False
            for b in range(B):
                with trace.span("fit.step"):
                    xb, keep = batches[b], None
                    if dp is not None:
                        # the whole minibatch's masks, then this rank's rows
                        if use_dropout:
                            keep = model.draw_dropout_keep(batch_size, gen,
                                                           device)
                        rows = dp.rows(batch_size)
                        share = loss_share(xb[rows, 4], block_wsum_total(
                            xb[:, 4], dp.world), dp.world)
                        xb = xb[rows]
                        keep = keep[rows] if keep is not None else None
                    _zero_grads(params, layout)
                    loss = training_loss(spec, model, xb[:, 0:2], xb[:, 2:3],
                                         xb[:, 3:4], xb[:, 4], train=True,
                                         generator=gen, dropout_keep=keep)
                    if dp is not None:
                        loss = loss * share
                    loss.backward()
                    if epoch == session_start and b == 0:
                        _check_grad_views(model, params, layout)
                    if dp is not None:
                        lv = sync_gradients_(dp, params, loss)
                    _transform_grads(spec, model, groups,
                                     layout is not None)
                    s = epoch * B + b
                    opt.step({"mlp": float(lr_mlp[s]),
                              "basis": float(lr_basis[s])})
                    ema_update(ema, params, data.ema_decay)
                    if dp is None:
                        lv = float(loss.detach())
                    loss_sum += lv
                    if not math.isfinite(lv):
                        nan_epoch = True
                        break
            train_loss = math.nan if nan_epoch else loss_sum / max(B, 1)
            t1 = time.perf_counter()
            if spec.ablate_validate:
                val_loss, val_rmse = train_loss, 0.0
            else:
                val_loss, val_rmse = _validate(spec, ema_model, data, dp)
            t_steps += t1 - t0
            t_val += time.perf_counter() - t1
            if epoch == session_start:
                t_first = t1 - t0      # includes the process's first launches

            improved = (math.isfinite(val_loss)
                        and val_loss < book["best_val"])
            if improved:
                book["best_val"], book["has_best"] = val_loss, True
                with torch.no_grad():
                    for dst, src in zip(best_ema, ema):
                        dst.copy_(src)
            sig_best = book["sig_best"]
            sig_thresh = (sig_best - spec.min_rel_delta * abs(sig_best)
                          if math.isfinite(sig_best) else sig_best)
            if math.isfinite(val_loss) and val_loss < sig_thresh:
                book["sig_best"], book["patience_ctr"] = val_loss, 0
            else:
                book["patience_ctr"] += 1
            hist["train_loss"].append(train_loss)
            hist["val_loss"].append(val_loss)
            hist["val_rmse"].append(val_rmse)
            if spec.record_centers:
                # a padded lane's junk centers stay at their init 0, so the
                # max is the real centers' (pad_lane_model's invariant)
                with torch.no_grad():
                    c = model.basis.centers
                    hist["center_shift"].append(float(torch.max(torch.abs(
                        c - model.spatial_centers_init))))
                    if (epoch + 1) % CENTERS_EVERY == 0:
                        centers_history.append(
                            (epoch + 1, c.detach().cpu().numpy().copy()))
            if epoch == session_start:
                t_first_epoch = time.perf_counter() - t0
            if verbose:
                print(f"  epoch {epoch + 1:4d} train {train_loss:.6f} "
                      f"val {val_loss:.6f} rmse {val_rmse:.6f}", flush=True)
            epochs_done = epoch + 1
            if book["patience_ctr"] >= spec.patience:
                book["stopped"], book["stop_epoch"] = True, epoch + 1
                if verbose:
                    print(f"Early stopping at epoch {epoch + 1}")
            if checkpoint_path is not None and (
                    dp is None or dp.primary) and (
                    (epochs_done - session_start) % chunk == 0
                    or epochs_done == session_limit or book["stopped"]):
                save()
    t_epochs = time.perf_counter() - t_loop

    stopped = book["stopped"]
    n_run = book["stop_epoch"] if stopped else epochs_done
    history = {k: np.asarray(hist[k][:n_run], np.float64)
               for k in ("train_loss", "val_loss", "val_rmse")}
    history["lr"] = lr_recorded[:n_run].copy()
    final_ema = to_jax_params(ema_model)
    if book["has_best"]:
        with torch.no_grad():
            for dst, src in zip(ema, best_ema):
                dst.copy_(src)
    serving = to_jax_params(ema_model)
    return FitResult(
        params=serving, history=history,
        best_val=float(book["best_val"]), n_epochs_run=n_run,
        stopped_early=stopped,
        center_shift=np.asarray(hist["center_shift"][:n_run]),
        n_steps=opt.step_count, n_val_chunks=spec.n_val_chunks,
        # epochs_seconds / first_epoch_seconds: the loop's wall, steps,
        # validation and bookkeeping, as `fit_lanes` records them
        timings={"train_steps_seconds": t_steps, "validate_seconds": t_val,
                 "first_epoch_steps_seconds": t_first,
                 "epochs_seconds": t_epochs,
                 "first_epoch_seconds": t_first_epoch},
        final_ema=final_ema,
        centers_history=tuple((e, c) for e, c in centers_history
                              if e <= n_run))


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------

# the predict requests of this process: the tracer's `request` id of each
_request_ids = itertools.count(1)


def _copy_in(coords: np.ndarray, t: np.ndarray, s: int, chunk: int,
             device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A chunk's coords (c, 2) and t (c, 1) on `device`: one
    `predict.copy_in` span."""
    with trace.span("predict.copy_in"):
        c = np.ascontiguousarray(coords[s:s + chunk], np.float32)
        tt = np.ascontiguousarray(t[s:s + chunk].reshape(-1, 1), np.float32)
        return (torch.as_tensor(c, device=device),
                torch.as_tensor(tt, device=device))


def _gather(outs: List[torch.Tensor], dim: int) -> np.ndarray:
    """The chunks' outputs joined on the host: one `predict.gather`
    span."""
    with trace.span("predict.gather"):
        return torch.cat(outs, dim=dim).cpu().numpy()


@torch.no_grad()
def predict(model: STInterp, coords: np.ndarray, t: np.ndarray,
            chunk: int = 32768) -> np.ndarray:
    """Dense inference in chunks of `chunk` points: (n, out_dim) numpy.
    It takes the fused forward where the spec allows it (no covariates, not
    a ragged-k lane: JAX loop.py:1348), else the materialised-phi one. A
    call is a `predict.request` span of the tracer: a `predict.copy_in` and
    a `predict.forward` a chunk, then one `predict.gather`."""
    device = next(model.parameters()).device
    fused = model.spec.fused_predict
    n = coords.shape[0]
    outs = []
    with trace.span("predict.request", request=next(_request_ids)):
        for s in range(0, n, chunk):
            c, tt = _copy_in(coords, t, s, chunk, device)
            with trace.span("predict.forward"):
                outs.append(model(c, tt, train=False, fused=fused))
        return _gather(outs, 0)


def n_predict_chunks(n: int, chunk: int = 32768) -> int:
    return -(-n // chunk)


# ---------------------------------------------------------------------------
# M fits as lanes of one program (JAX _run_epoch / _epoch_bookkeeping, vmapped)
# ---------------------------------------------------------------------------

class LaneData(NamedTuple):
    """M lanes' padded buffers on the fit's device, stacked on a leading
    lane dimension and padded to shared capacities."""
    packed_tr: torch.Tensor   # (M, cap_tr, 5): coords | t | y | w
    va_coords: torch.Tensor   # (M, cap_va, 2)
    va_t: torch.Tensor        # (M, cap_va, 1)
    va_y: torch.Tensor        # (M, cap_va, 1)
    va_w: torch.Tensor        # (M, cap_va)
    n_batches: Tuple[int, ...]       # each lane's real batches per epoch
    ema_decay: Tuple[float, ...]     # each lane's 1 - 1/(10 B_lane), float32
    batch_size: int
    val_chunk: int

    @property
    def B_shared(self) -> int:
        return self.packed_tr.shape[1] // self.batch_size

    @property
    def n_val_chunks(self) -> int:
        return self.va_coords.shape[1] // self.val_chunk


def stack_lane_data(cfg: ExperimentConfig, train_sets: Sequence[PointSet],
                    valid_sets: Sequence[PointSet], device: torch.device
                    ) -> LaneData:
    """Lane stacking (JAX batch_engine.py:715-743): one batch size for all
    lanes, from the smallest training set; the widest lane's batch count and
    validation set give the shared capacities; each lane keeps its own batch
    count and EMA decay."""
    batch_size = adaptive_batch_size(min(p.n_real for p in train_sets),
                                     cfg.batch_size)
    B_shared = max(max(1, -(-p.n_real // batch_size)) for p in train_sets)
    max_val = max(max(1, p.n_real) for p in valid_sets)
    val_chunk = min(max(batch_size * 16, 32768), max_val)
    n_val_chunks = max(1, -(-max_val // val_chunk))
    datas, n_batches = [], []
    for tr, va in zip(train_sets, valid_sets):
        d, B_lane, _ = prepare_train_data(
            tr, va, batch_size, device, val_chunk=val_chunk,
            cap_tr=B_shared * batch_size, cap_va=n_val_chunks * val_chunk)
        datas.append(d)
        n_batches.append(B_lane)
    stack = lambda name: torch.stack([getattr(d, name) for d in datas])
    packed = torch.cat([stack("tr_coords"), stack("tr_t"), stack("tr_y"),
                        stack("tr_w")[..., None]], dim=2)
    return LaneData(packed_tr=packed, va_coords=stack("va_coords"),
                    va_t=stack("va_t"), va_y=stack("va_y"),
                    va_w=stack("va_w"), n_batches=tuple(n_batches),
                    ema_decay=tuple(d.ema_decay for d in datas),
                    batch_size=batch_size, val_chunk=val_chunk)


def lane_data_to(data: LaneData, device: torch.device) -> LaneData:
    """`data` with its buffers on `device`."""
    return data._replace(**{f: getattr(data, f).to(device) for f in
                            ("packed_tr", "va_coords", "va_t", "va_y",
                             "va_w")})


def shuffle_lane_indices_(idx: torch.Tensor, n_batches: Sequence[int],
                          batch_size: int,
                          generators: Sequence[torch.Generator]) -> None:
    """In place: row i of idx (M, B_shared * batch_size) gets a fresh
    permutation of lane i's own capacity, n_batches[i] * batch_size, from
    lane i's generator. A lane's executed batches (its first n_batches[i])
    then hold all of its points, however many batches the widest lane has;
    the rest of the row is never executed."""
    for i, g in enumerate(generators):
        cap_lane = n_batches[i] * batch_size
        idx[i, :cap_lane] = torch.randperm(cap_lane, generator=g,
                                           device=idx.device)


def lane_losses_from_preds(spec: LoopSpec, model: STInterpLanes,
                           preds: torch.Tensor, y: torch.Tensor,
                           w: torch.Tensor, train: bool,
                           taus: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """`loss_from_preds` a lane: preds (M, B, Q), y (M, B, 1), w (M, B) ->
    (M,) composite objectives. A quantile fit takes `taus` (M,), a lane's
    own tau, where given, else `spec.current_quantile`."""
    m = spec.model
    if spec.regression_type == "mean":
        loss = mse_loss_lanes(preds, y, w)
    elif spec.regression_type == "quantile":
        loss = quantile_loss_lanes(
            preds, y, float(spec.current_quantile) if taus is None else taus,
            w)
    elif spec.regression_type == "multi-quantile":
        q = torch.tensor(spec.quantile_levels, dtype=torch.float32,
                         device=preds.device)
        loss = multi_quantile_loss_lanes(preds, y, q, w)
        if m.use_delta_reparameterization and m.delta_head:
            if spec.non_crossing_lambda > 0:
                p_nc = p_nc_delta_penalty_lanes(model.mlp.delta)
                if spec.non_crossing_delta_mode == "abs":
                    p_nc = -p_nc
                loss = loss + spec.non_crossing_lambda * p_nc
        elif spec.non_crossing_weight > 0:
            loss = loss + spec.non_crossing_weight * non_crossing_penalty_lanes(
                preds, spec.non_crossing_power, w)
    else:
        raise ValueError(f"Unknown regression_type: {spec.regression_type}")

    if train:
        if m.spatial_learnable:
            if spec.domain_penalty_weight > 0:
                loss = loss + spec.domain_penalty_weight * model.domain_penalty()
            if spec.movement_penalty_weight > 0:
                loss = loss + (spec.movement_penalty_weight
                               * model.movement_penalty())
        if spec.sparsity_penalty_type != "none":
            pen = model.sparsity_penalty(spec.sparsity_penalty_type,
                                         spec.sparsity_lambda_l1,
                                         spec.sparsity_lambda_group)
            if spec.sparsity_apply_to_spatial:
                loss = loss + pen["spatial_penalty"]
            if spec.sparsity_apply_to_temporal:
                loss = loss + pen["temporal_penalty"]
    return loss


def _transform_grads_lanes(spec: LoopSpec, model: STInterpLanes,
                           groups: Dict[str, List[torch.Tensor]],
                           packed: bool = False) -> None:
    """`_transform_grads` with each lane's own clipping norms."""
    _damp_centers(spec, model, packed)
    if spec.grad_clip > 0:
        if "basis" in groups:
            clip_by_global_norm_lanes_([p.grad for p in groups["basis"]],
                                       spec.grad_clip * 0.1)
        clip_by_global_norm_lanes_([p.grad for p in groups["mlp"]],
                                   spec.grad_clip)


@torch.no_grad()
def _validate_lanes(spec: LoopSpec, ema: STInterpLanes, data: LaneData,
                    taus: Optional[torch.Tensor] = None,
                    dp: Optional[DPGroup] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_validate` for all lanes in one forward per chunk: (val_loss (M,),
    val_rmse (M,)) on the device. With `dp`, each rank evaluates its rows
    of every chunk and one all_reduce completes the sums, as `_validate`
    does; rank 0's result is broadcast."""
    C = spec.val_chunk
    loss_sum = valid = se = cnt = 0.0
    for i in range(spec.n_val_chunks):
        sl = slice(i * C, (i + 1) * C)
        ck, tk, yk, wk = (data.va_coords[:, sl], data.va_t[:, sl],
                          data.va_y[:, sl], data.va_w[:, sl])
        n_real = torch.sum(wk, dim=1)
        if dp is not None:
            rows = dp.rows(wk.shape[1])
            ck, tk, yk, wk = (x[:, rows].contiguous()
                              for x in (ck, tk, yk, wk))
        preds = ema(ck, tk, train=False)
        loss = lane_losses_from_preds(spec, ema, preds, yk, wk, train=False,
                                      taus=taus)
        if dp is not None:
            loss = loss * (torch.sum(wk, dim=1)
                           / torch.clamp(n_real, min=1e-12))
        if spec.regression_type == "multi-quantile":
            mid = len(spec.quantile_levels) // 2
            preds = preds[..., mid:mid + 1]
        has_real = (n_real > 0).float()
        loss_sum = loss_sum + loss * has_real
        valid = valid + has_real
        se = se + torch.sum((preds - yk) ** 2 * wk[..., None], dim=(1, 2))
        cnt = cnt + n_real
    if dp is not None:
        loss_sum, se = validation_sums(dp, (loss_sum, se))
    val_loss = loss_sum / torch.clamp(valid, min=1.0)
    val_rmse = torch.sqrt(se / torch.clamp(cnt, min=1.0))
    if dp is not None:
        val_loss, val_rmse = dp.broadcast_(torch.stack([val_loss, val_rmse]))
    return val_loss, val_rmse


class _LaneRun(NamedTuple):
    """The state of a lane fit that has a lane dimension and is not
    bookkeeping: the model and its EMA copy, the optimizer, the tensors it
    updates, the EMA and best-EMA tensors in the same order, the packing
    (None unpacked)."""
    model: STInterpLanes
    ema_model: STInterpLanes
    opt: AdamWLanes
    groups: Dict[str, List[torch.Tensor]]
    params: List[torch.Tensor]
    ema: List[torch.Tensor]
    best: List[torch.Tensor]
    layout: Optional[PackSpec]


def _lane_run(model: STInterpLanes, ema_model: STInterpLanes, packed: bool,
              weight_decay: float,
              best: Optional[Sequence[torch.Tensor]] = None,
              opt: Optional[AdamWLanes] = None,
              idx: Optional[torch.Tensor] = None) -> _LaneRun:
    """A fresh lane run of `model`, or, with `opt` and `idx`, the run of
    lanes `idx` of another (tail compaction): `model` and `ema_model` are
    then the narrowed models, `best` and the optimizer's state are
    gathered."""
    groups, params, ema, layout = _optimizer_tensors(model, ema_model, packed)
    if opt is None:
        opt = AdamWLanes(groups, weight_decay)
        best = [p.detach().clone() for p in ema]
    else:
        opt = opt.narrowed(groups, idx)
        best = [b[idx] for b in best]
    return _LaneRun(model, ema_model, opt, groups, params, ema, best, layout)


def _compaction_width(stopped: np.ndarray) -> Optional[np.ndarray]:
    """The lanes of a narrowed batch (JAX batch_engine.py:946-965, one
    device), or None where the batch does not narrow: the active lanes,
    padded with distinct stopped ones to the next multiple of
    q = max(M // 4, 4) lanes; it narrows only to a width below M."""
    M = stopped.shape[0]
    act = np.flatnonzero(~stopped)
    q = max(M // 4, 4)
    W = -(-max(len(act), 1) // q) * q
    if len(act) == 0 or W >= M:
        return None
    return np.concatenate([act, np.flatnonzero(stopped)[:W - len(act)]])


def fit_lanes(cfg: ExperimentConfig, spec_model: ModelSpec,
              model: STInterpLanes, data: LaneData, lr_steps: np.ndarray,
              lr_recorded: Sequence[np.ndarray], seeds: Sequence[int],
              verbose: bool = False,
              taus: Optional[Sequence[float]] = None,
              dp: Optional[DPGroup] = None,
              serving_out: Optional[Dict[str, Any]] = None
              ) -> List[FitResult]:
    """Train the M lanes of `model` in place; one FitResult a lane.

    `lr_steps` (M, epochs, B_shared, 2) holds each lane's per-step (MLP,
    basis) LRs and is uploaded once; `lr_recorded[i]` (epochs,) is lane i's
    recorded LR; `seeds[i]` seeds lane i's shuffle: under 'auto' and
    'hash', lanes of one batch count (uniform lanes) permute by the
    bijection, each with the multipliers its own generator draws, where
    its single fit draws them; lanes of different batch counts, and every
    lane under 'perm', by `shuffle_lane_indices_`. A step executes in a
    lane only while b < the lane's batch count, no earlier batch of the
    epoch gave the lane a non-finite loss, and the lane has not stopped; a
    stopped lane keeps its whole state and writes NaN history rows. No step
    reads a device value on the host or loops over lanes; the host reads
    `stopped.all()` once an epoch. Histories are cut at each lane's own stop
    epoch. `timings['epochs_seconds']` is the loop's wall (steps,
    validation and bookkeeping; the card is waited for once an epoch).
    `taus[i]` is lane i's tau of a quantile fit (default: the config's):
    one tau for all lanes is a float of the loss, as in the single fit;
    several become lane data (JAX batch_engine.py:808-836).

    `packed_optimizer` runs the step on two flat group buffers
    (`train/packing.py`). `tail_compaction` (JAX batch_engine.py:906-1030)
    tries at each multiple of `compaction_epoch` below `epochs`, until it
    narrows once, to gather the active lanes, padded with stopped ones
    (`_compaction_width`), into a narrower batch: their parameters,
    optimizer state, EMA and best EMA, stop book, LR tables, data, shuffle
    generators and index rows. The dropout draw stays full-width and each
    lane takes its own row, so every lane's masks, and so its results, are
    those of the full-width run. After the last epoch the narrow state is
    scattered back into the full batch, whose stopped lanes were frozen.

    With `dp` (`parallel.data_parallel.DPGroup`), every lane is a
    data-parallel fit over the group's ranks (lanes nested over an 'exp' x
    'data' mesh, JAX `jitted_fit_chunk(spec_dp, vmapped=True, mesh=...,
    spmd_axis='exp')`): rank 0's lanes go to every rank; every rank draws
    the epoch's shuffle and each minibatch's whole dropout block from the
    generators above and takes its rows of the minibatch (`dp.rows`); each
    lane's loss takes its `loss_share`; one all_reduce a step sums the
    lane-stacked gradients and losses, and validation sums its ranks'
    shares. So the fit is this fit on one process up to the order of its
    sums, with the packed optimizer and tail compaction as well.

    With `serving_out` (a dict), the serving params (best EMA where a lane
    has one, else its EMA) and the final EMA stay on the device, lane
    stacked, as serving_out['params'] and serving_out['final_ema']
    ({name: (M, ...) tensor}), and each FitResult's `params` and
    `final_ema` are None: a caller that needs them pulls them
    (`pull_lane_params`)."""
    device = data.packed_tr.device
    M, cap = data.packed_tr.shape[0], data.packed_tr.shape[1]
    bs, B = data.batch_size, data.B_shared
    E = int(cfg.epochs)
    if model.lanes != M or len(seeds) != M or lr_steps.shape != (M, E, B, 2):
        raise ValueError(f"{M} lanes of data: model has {model.lanes}, "
                         f"{len(seeds)} seeds, lr_steps {lr_steps.shape} "
                         f"(expected {(M, E, B, 2)})")
    spec = LoopSpec.from_config(cfg, spec_model, bs, B, data.val_chunk,
                                data.n_val_chunks)
    f32 = dict(dtype=torch.float32, device=device)
    tau_lanes = None
    if spec.regression_type == "quantile":
        taus = [float(spec.current_quantile)] * M if taus is None else taus
        if len(taus) != M:
            raise ValueError(f"{len(taus)} taus for {M} lanes")
        if len(set(taus)) == 1:
            spec = dataclasses.replace(spec, current_quantile=float(taus[0]))
        else:
            tau_lanes = torch.tensor([float(q) for q in taus], **f32)
    lr_t = torch.as_tensor(np.ascontiguousarray(
        np.transpose(lr_steps, (1, 2, 0, 3)), np.float32), device=device)
    if not spec_model.spatial_learnable:
        lr_t = lr_t[..., :1]
    n_batches = torch.tensor(data.n_batches, dtype=torch.int32, device=device)
    inf = torch.full((M,), math.inf, **f32)
    # every per-lane tensor of the loop, lane dimension first (the in_lane
    # mask (M, B) is transposed at use): tail compaction gathers them all
    book = dict(
        n_batches_f=torch.clamp(n_batches.to(torch.float32), min=1.0),
        in_lane=(torch.arange(B, device=device)[None, :]
                 < n_batches[:, None]),                           # (M, B)
        decay=torch.tensor(data.ema_decay, **f32),
        one_minus_decay=torch.tensor([np.float32(1.0 - d)
                                      for d in data.ema_decay], **f32),
        best_val=inf.clone(), sig_best=inf.clone(),
        has_best=torch.zeros((M,), dtype=torch.bool, device=device),
        stopped=torch.zeros((M,), dtype=torch.bool, device=device),
        patience_ctr=torch.zeros((M,), dtype=torch.int32, device=device),
        stop_epoch=torch.zeros((M,), dtype=torch.int32, device=device),
        idx=(torch.arange(B * bs, device=device) % cap).repeat(M, 1))
    if tau_lanes is not None:
        book["tau"] = tau_lanes
    packed = bool(cfg.packed_optimizer)
    if dp is not None:
        dp.broadcast_module_(model)
    rows = None if dp is None or dp.world == 1 else dp.rows(bs)
    run = _lane_run(model, copy.deepcopy(model), packed, spec.weight_decay)
    full = run
    nan = torch.full((M,), math.nan, **f32)
    hist = {k: torch.full((E, M), math.nan, **f32)
            for k in ("train_loss", "val_loss", "val_rmse", "center_shift")}

    hashed = (spec.shuffle in ("auto", "hash")
              and all(nb == B for nb in data.n_batches))
    lane_gens = [torch.Generator(device=device).manual_seed(int(sd))
                 for sd in seeds]
    drop_gen = torch.Generator(device=device).manual_seed(int(seeds[0]))
    compact = (bool(cfg.tail_compaction)
               and 0 < int(cfg.compaction_epoch) < E and M >= 2)
    # the narrowed batch: lanes of the full batch (device and host), or
    # None at full width
    lane_idx, lane_idx_h = None, None
    lane_data = data
    views_checked = False

    def epoch_batches() -> Tuple[torch.Tensor, ...]:
        """The epoch's minibatches, step-major and contiguous: coords
        (B, W, bs, 2), t and y (B, W, bs, 1), w (B, W, bs)."""
        order = book["idx"]
        W = order.shape[0]
        if hashed:                    # cap == B * bs: every lane is uniform
            order = hash_permutation_any(torch.stack(
                [hash_multipliers(cap, g, device) for g in lane_gens]), cap)
        elif spec.shuffle != "none":
            shuffle_lane_indices_(book["idx"], lane_data.n_batches, bs,
                                  lane_gens)
        lane_ar = torch.arange(W, device=device)[:, None]
        packed_b = lane_data.packed_tr[lane_ar, order].reshape(W, B, bs, 5)
        packed_b = packed_b.transpose(0, 1)
        return (packed_b[..., 0:2].contiguous(),
                packed_b[..., 2:3].contiguous(),
                packed_b[..., 3:4].contiguous(), packed_b[..., 4].contiguous())

    t_first = 0.0
    epochs_done = 0
    centers_history: List[Tuple[int, np.ndarray]] = []
    t_loop = time.perf_counter()
    for epoch in range(E):
        t0 = time.perf_counter()
        with trace.span("fit.epoch", epoch=epoch):
            if (compact and lane_idx is None and epoch > 0
                    and epoch % int(cfg.compaction_epoch) == 0):
                with trace.span("fit.compaction"):
                    sel = _compaction_width(book["stopped"].cpu().numpy())
                    if sel is not None:
                        full_book, lane_idx_h = book, sel
                        lane_idx = torch.as_tensor(sel, device=device)
                        run = _lane_run(select_lanes(run.model, lane_idx),
                                        select_lanes(run.ema_model, lane_idx),
                                        packed, spec.weight_decay, run.best,
                                        run.opt, lane_idx)
                        book = {k: v[lane_idx] for k, v in book.items()}
                        lr_t = lr_t[:, :, lane_idx]
                        lane_data = data._replace(
                            n_batches=tuple(data.n_batches[i] for i in sel),
                            ema_decay=tuple(data.ema_decay[i] for i in sel),
                            **{f: getattr(data, f)[lane_idx] for f in
                               ("packed_tr", "va_coords", "va_t", "va_y",
                                "va_w")})
                        lane_gens = [lane_gens[i] for i in sel]
                        views_checked = False
                        if verbose:
                            print(f"[batch] tail compaction {M}->{len(sel)} "
                                  f"lanes at epoch {epoch} "
                                  f"({int((~book['stopped']).sum())} active)",
                                  flush=True)
            Wn = run.model.lanes
            drop_rows = None if lane_idx is None else (M, lane_idx)
            with trace.span("fit.shuffle"):
                coords_e, t_e, y_e, w_e = epoch_batches()
            stopped = book["stopped"]
            alive = ~stopped
            in_lane = book["in_lane"].t()
            nan_epoch = torch.zeros_like(stopped)
            loss_sum = torch.zeros((Wn,), **f32)
            for b in range(B):
                with trace.span("fit.step"):
                    _zero_grads(run.params, run.layout)
                    cb, tb, yb, wb = coords_e[b], t_e[b], y_e[b], w_e[b]
                    if rows is not None:
                        # the whole minibatch's weights give each lane's
                        # share; then this rank's rows of it
                        share = loss_share(wb[:, rows], block_wsum_total(
                            wb, dp.world), dp.world)
                        cb, tb, yb, wb = (x[:, rows].contiguous()
                                          for x in (cb, tb, yb, wb))
                    with trace.span("step.forward"):
                        preds = run.model(cb, tb, train=True,
                                          generator=drop_gen,
                                          drop_rows=drop_rows,
                                          drop_points=None if rows is None
                                          else (bs, rows))
                        loss = lane_losses_from_preds(
                            spec, run.model, preds, yb, wb, train=True,
                            taus=book.get("tau"))
                    if rows is not None:
                        loss = loss * share
                    with trace.span("step.backward"):
                        # lanes share no parameter: the sum's gradient is
                        # each lane's own
                        loss.sum().backward()
                        if not views_checked:
                            _check_grad_views(run.model, run.params,
                                              run.layout)
                            views_checked = True
                        loss_d = (loss.detach() if dp is None
                                  else sync_lane_gradients_(dp, run.params,
                                                            loss))
                        _transform_grads_lanes(spec, run.model, run.groups,
                                               run.layout is not None)
                    executes = in_lane[b] & ~nan_epoch & alive
                    with trace.span("step.optimizer"):
                        run.opt.step(lr_t[epoch, b], executes)
                        ema_update_lanes(run.ema, run.params, book["decay"],
                                         book["one_minus_decay"], executes)
                    with torch.no_grad():
                        loss_sum = loss_sum + torch.where(
                            executes, loss_d, torch.zeros_like(loss_d))
                        nan_epoch = nan_epoch | (executes
                                                 & ~torch.isfinite(loss_d))
            with torch.no_grad():
                nan_w = nan if lane_idx is None else nan[:Wn]
                train_loss = torch.where(nan_epoch, nan_w,
                                         loss_sum / book["n_batches_f"])
                with trace.span("fit.validate"):
                    if spec.ablate_validate:
                        val_loss, val_rmse = (train_loss,
                                              torch.zeros_like(train_loss))
                    else:
                        val_loss, val_rmse = _validate_lanes(
                            spec, run.ema_model, lane_data, book.get("tau"),
                            dp)
                with trace.span("fit.bookkeeping"):
                    # JAX _epoch_bookkeeping, a lane each
                    best_val, sig_best = book["best_val"], book["sig_best"]
                    patience_ctr = book["patience_ctr"]
                    finite = torch.isfinite(val_loss)
                    improved = finite & (val_loss < best_val) & alive
                    sig_thresh = torch.where(
                        torch.isfinite(sig_best),
                        sig_best - spec.min_rel_delta * torch.abs(sig_best),
                        sig_best)
                    sig_improved = finite & (val_loss < sig_thresh)
                    ctr = torch.where(sig_improved,
                                      torch.zeros_like(patience_ctr),
                                      patience_ctr + 1)
                    stop_now = (ctr >= spec.patience) & alive
                    book["best_val"] = torch.where(improved, val_loss,
                                                   best_val)
                    book["has_best"] = book["has_best"] | improved
                    book["sig_best"] = torch.where(sig_improved & alive,
                                                   val_loss, sig_best)
                    book["patience_ctr"] = torch.where(alive, ctr,
                                                       patience_ctr)
                    book["stop_epoch"] = torch.where(
                        stop_now,
                        torch.full_like(book["stop_epoch"], epoch + 1),
                        book["stop_epoch"])
                    book["stopped"] = stopped | stop_now
                    for dst, src in zip(run.best, run.ema):
                        dst.copy_(torch.where(
                            improved.reshape(Wn, *([1] * (dst.dim() - 1))),
                            src, dst))
                    cols = slice(None) if lane_idx is None else lane_idx
                    hist["train_loss"][epoch, cols] = torch.where(
                        alive, train_loss, nan_w)
                    hist["val_loss"][epoch, cols] = torch.where(
                        alive, val_loss, nan_w)
                    hist["val_rmse"][epoch, cols] = torch.where(
                        alive, val_rmse, nan_w)
                    if spec.record_centers:
                        centers = run.model.basis.centers
                        hist["center_shift"][epoch, cols] = torch.amax(
                            torch.abs(centers
                                      - run.model.spatial_centers_init),
                            dim=(1, 2))
                        if (epoch + 1) % CENTERS_EVERY == 0:
                            c = centers.cpu().numpy()
                            if lane_idx_h is not None:
                                # the narrowed lanes over the full batch's
                                # frozen rows: a stopped lane's rows after
                                # its stop epoch are cut below
                                c, c[lane_idx_h] = (
                                    full.model.basis.centers.cpu().numpy(), c)
                            centers_history.append((epoch + 1, c))
                    epochs_done = epoch + 1
                    with trace.span("fit.host_read"):
                        # the epoch's host read
                        all_stopped = bool(book["stopped"].all())
            if epoch == 0:
                t_first = time.perf_counter() - t0
            if verbose and (epoch % 25 == 0 or all_stopped or epoch == E - 1):
                vals = val_loss.cpu().numpy()
                print(f"  epoch {epoch + 1:4d} lanes stopped "
                      f"{int(book['stopped'].sum())}/{Wn}  val "
                      f"{np.array2string(vals, precision=5)}", flush=True)
        if all_stopped:
            break
    t_epochs = time.perf_counter() - t_loop

    with torch.no_grad():
        if lane_idx is not None:
            # the narrow state back into the full batch, for finalize and
            # the caller's model
            for dst_l, src_l in ((full.params, run.params),
                                 (full.ema, run.ema), (full.best, run.best)):
                for dst, src in zip(dst_l, src_l):
                    dst[lane_idx] = src
            full.opt.step_count[lane_idx] = run.opt.step_count
            narrow_book, book = book, full_book
            for k in ("best_val", "has_best", "stopped", "stop_epoch"):
                book[k][lane_idx] = narrow_book[k]
        has_best = book["has_best"]
        best_named = dict(zip(
            [n for n, _ in model.named_parameters()],
            _leaves(full.layout, full.best)))
        serving = {name: torch.where(
            has_best.reshape(M, *([1] * (e.dim() - 1))), best_named[name],
            e) for name, e in full.ema_model.named_parameters()}
        final = {name: e.detach()
                 for name, e in full.ema_model.named_parameters()}
        if serving_out is not None:
            serving_out.update(params=serving, final_ema=final)
            serving_h = final_h = [None] * M
        else:
            serving_h, final_h = (pull_lane_params(serving),
                                  pull_lane_params(final))
    hist_h = {k: v.cpu().numpy().astype(np.float64) for k, v in hist.items()}
    stopped_h = book["stopped"].cpu().numpy()
    stop_epoch_h = book["stop_epoch"].cpu().numpy()
    best_val_h = book["best_val"].cpu().numpy()
    steps_h = full.opt.step_count.cpu().numpy()
    results = []
    for i in range(M):
        n_run = int(stop_epoch_h[i]) if stopped_h[i] else epochs_done
        history = {k: hist_h[k][:n_run, i].copy()
                   for k in ("train_loss", "val_loss", "val_rmse")}
        history["lr"] = np.asarray(lr_recorded[i][:n_run]).copy()
        results.append(FitResult(
            params=serving_h[i],
            history=history, best_val=float(best_val_h[i]),
            n_epochs_run=n_run, stopped_early=bool(stopped_h[i]),
            center_shift=(hist_h["center_shift"][:n_run, i].copy()
                          if spec.record_centers else np.asarray([])),
            n_steps=int(steps_h[i]), n_val_chunks=spec.n_val_chunks,
            timings={"epochs_seconds": t_epochs,
                     "first_epoch_seconds": t_first,
                     "epochs_run_batch": float(epochs_done),
                     "steps_per_epoch_batch": float(B)},
            final_ema=final_h[i],
            centers_history=tuple((e, c[i].copy()) for e, c in
                                  centers_history if e <= n_run)))
    return results


def pull_lane_params(tree: Dict[str, torch.Tensor],
                     lanes: Optional[Sequence[int]] = None
                     ) -> List[Dict[str, Any]]:
    """Each lane's host param tree (the JAX layout) from a lane-stacked
    tree {name: (M, ...) tensor} of `fit_lanes(serving_out=...)`, for the
    lanes `lanes` (default all): one copy to the host a leaf."""
    host = {name: v.cpu().numpy() for name, v in tree.items()}
    if lanes is None:
        lanes = range(next(iter(host.values())).shape[0])
    return [lane_tree({name: v[i].copy() for name, v in host.items()})
            for i in lanes]


@torch.no_grad()
def predict_lanes(model: STInterpLanes, coords: np.ndarray, t: np.ndarray,
                  chunk: int = 32768) -> np.ndarray:
    """Dense inference of M lanes on shared points, one forward a chunk for
    all lanes: (M, n, out_dim) numpy; traced as `predict`."""
    device = next(model.parameters()).device
    M, n = model.lanes, coords.shape[0]
    outs = []
    with trace.span("predict.request", request=next(_request_ids)):
        for s in range(0, n, chunk):
            c, tt = _copy_in(coords, t, s, chunk, device)
            with trace.span("predict.forward"):
                outs.append(model(c.expand(M, -1, -1).contiguous(),
                                  tt.expand(M, -1, -1).contiguous(),
                                  train=False))
        return _gather(outs, 1)
