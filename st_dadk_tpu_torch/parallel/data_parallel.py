"""Data parallelism inside one fit on torch.distributed (port of
`st_dadk_tpu/parallel/data_parallel.py`).

Each rank takes its rows of the minibatch and computes the gradient of its
share of the objective; one `all_reduce` sums the gradients and the loss,
and the sum over n ranks is divided by n. Parameters, AdamW moments and the
EMA are replicated: every rank applies the same update to the same values.

Weighted means under uneven padding (JAX `:46-55`): the loss of a rank is
the weighted mean of its own rows, and the mean over ranks of those means
is not the global weighted mean when the pad rows (weight 0) gather on one
rank. Each rank therefore scales its loss by wsum_r * n / sum_r wsum_r
(`loss_share`), so that the mean over ranks is sum_r wsum_r mean_r / W,
the global weighted mean the single fit computes; the replicated penalty
terms come through once, since the shares sum to n.

Two uses:
  - `make_dp_train_step`: a step on rows the caller has already split (JAX
    `make_dp_train_step`); each rank draws its dropout masks from its own
    stream (`rank_generator`), as JAX's `fold_in(axis_index)` decorrelates
    them;
  - `train/loop.py::fit(dp=...)`, the data-parallel fit (JAX `fit(mesh=...,
    dp_axis='data')`): every rank draws the epoch's shuffle and the whole
    minibatch's dropout block from one generator and takes its own rows, so
    the fit is the single fit's arithmetic up to the order of the sums (and
    bitwise the single fit on one rank); `train/loop.py::fit_lanes(dp=...)`
    does the same for each lane of a batch (lanes nested over exp x data),
    with one all_reduce a step of the lane-stacked gradients and losses.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# a rank's dropout stream for `make_dp_train_step`: seed + rank * this
RANK_STREAM_STRIDE = 1_000_003


@dataclass(frozen=True)
class DPGroup:
    """The ranks one fit runs over: this process's `rank` of `world`, the
    process `group` (None: the default group, or no collective at all on
    one rank with no group joined), and the rank's `device`."""
    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None

    @classmethod
    def default(cls, device: torch.device | str) -> "DPGroup":
        """Every rank of the default group, or this process alone."""
        if dist.is_available() and dist.is_initialized():
            return cls(dist.get_rank(), dist.get_world_size(),
                       torch.device(device))
        return cls(0, 1, torch.device(device))

    @classmethod
    def from_mesh(cls, mesh, device: torch.device | str,
                  axis: str = "data") -> "DPGroup":
        """This rank's row along `axis` of a `parallel.mesh.RankMesh`. Under
        gloo the row's group is built as a CPU mesh's (gloo moves the
        card's tensors too): a CUDA `DeviceMesh` would pick each rank's card
        by its local rank, and several ranks may share one card."""
        kind = torch.device(device).type
        if dist.is_available() and dist.is_initialized() \
                and dist.get_backend() == "gloo":
            kind = "cpu"
        group = mesh.axis_group(axis, kind)
        if group is None:
            return cls(0, 1, torch.device(device))
        return cls(dist.get_rank(group), dist.get_world_size(group),
                   torch.device(device), group)

    @property
    def joined(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of n: contiguous, the first n % world ranks
        one row longer."""
        return row_slice(n, self.rank, self.world)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, in place; the identity with no group."""
        if self.joined:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's values on every rank, in place."""
        if self.joined:
            src = (dist.get_global_rank(self.group, 0)
                   if self.group is not None else 0)
            dist.broadcast(t, src=src, group=self.group)
        return t

    def broadcast_module_(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank, in place: one
        flat broadcast a dtype."""
        if not self.joined or self.world == 1:
            return
        tensors = [t for t in list(module.parameters())
                   + list(module.buffers()) if t is not None]
        with torch.no_grad():
            for dtype in dict.fromkeys(t.dtype for t in tensors):
                same = [t for t in tensors if t.dtype == dtype]
                flat = self.broadcast_(torch.cat([t.reshape(-1)
                                                  for t in same]))
                _unflatten_into(flat, same)


def row_slice(n: int, rank: int, world: int) -> slice:
    """Rows [lo, hi) of rank `rank` when n rows split over `world` ranks."""
    base, extra = divmod(n, world)
    lo = rank * base + min(rank, extra)
    return slice(lo, lo + base + (1 if rank < extra else 0))


def _unflatten_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]
                    ) -> None:
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def loss_share(w_local: torch.Tensor, wsum_total: torch.Tensor,
               world: int) -> torch.Tensor:
    """wsum_r * n / W: the factor on a rank's local weighted-mean loss
    whose mean over ranks is the global weighted mean (module docstring);
    exactly 1 on one rank. wsum_r is clamped at 1e-12, as in JAX. The rows
    are the last axis: lanes (M, n_r) give one factor a lane (M,)."""
    wsum = torch.clamp(torch.sum(w_local, dim=-1), min=1e-12)
    return wsum * world / wsum_total


def block_wsum_total(w: torch.Tensor, world: int) -> torch.Tensor:
    """sum_r max(wsum_r, 1e-12) over the ranks' row blocks of the full
    batch weights `w` (rows on the last axis; lanes first): what the
    all_reduce of the clamped local sums gives, computed by every rank from
    the batch it already holds."""
    n = w.shape[-1]
    sums = [torch.clamp(torch.sum(w[..., row_slice(n, r, world)], dim=-1),
                        min=1e-12) for r in range(world)]
    return sums[0] if world == 1 else torch.stack(sums).sum(dim=0)


def sync_gradients_(dp: DPGroup, tensors: Sequence[torch.Tensor],
                    loss: torch.Tensor) -> float:
    """Sum each tensor's `.grad` and `loss` over the ranks in one
    all_reduce, divide by n, write the gradients back in place; the mean
    loss as a float. One rank with no group: nothing moves."""
    return float(sync_lane_gradients_(dp, tensors, loss.reshape(1))[0])


def sync_lane_gradients_(dp: DPGroup, tensors: Sequence[torch.Tensor],
                         loss: torch.Tensor) -> torch.Tensor:
    """`sync_gradients_` for lanes: `loss` (M,) a lane; the mean loss over
    the ranks (M,), on the device (no host read)."""
    if not dp.joined:
        return loss.detach()
    grads = [t.grad for t in tensors]
    n = loss.numel()
    flat = _summed(dp, grads + [loss.detach().to(grads[0].dtype)])
    if dp.world > 1:
        flat.div_(dp.world)
    with torch.no_grad():
        _unflatten_into(flat[:-n], grads)
    return flat[-n:]


def _summed(dp: DPGroup, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors flattened into one buffer, summed over the ranks by one
    all_reduce."""
    return dp.all_reduce_(torch.cat([t.reshape(-1) for t in tensors]))


def rank_generator(seed: int, dp: DPGroup) -> torch.Generator:
    """The rank's own dropout stream for `make_dp_train_step`."""
    return torch.Generator(device=dp.device).manual_seed(
        int(seed) + dp.rank * RANK_STREAM_STRIDE)


def make_dp_train_step(spec, model, opt, ema: List[torch.Tensor],
                       dp: DPGroup,
                       transform: Optional[Callable] = None
                       ) -> Callable[..., float]:
    """A data-parallel train step (JAX `make_dp_train_step`, `:27-83`).

    step(coords, t, y, w, lrs, ema_decay, generator) -> the mean loss over
    the ranks, where (coords, t, y, w) are this rank's rows of the
    minibatch, `lrs` {'mlp': lr, 'basis': lr}, and `generator` the rank's
    dropout stream (`rank_generator`). The weights' global sum comes from
    one all_reduce; the gradients are summed, divided by n, transformed as
    the single fit transforms them (`transform`, default
    `train.loop._transform_grads`: center damping, clipping), and AdamW and
    the EMA (`ema`: a tensor a parameter of `model`, in its order) update
    the replicated state."""
    from st_dadk_tpu_torch.train.loop import _transform_grads, training_loss
    from st_dadk_tpu_torch.train.optimizer import ema_update
    params = list(model.parameters())     # `ema` is parallel to these
    transform = transform or (lambda: _transform_grads(spec, model))

    def step(coords, t, y, w, lrs, ema_decay: float,
             generator: torch.Generator) -> float:
        wsum = torch.clamp(torch.sum(w), min=1e-12)
        total = dp.all_reduce_(wsum.detach().clone().reshape(1))[0]
        for p in params:
            p.grad = None
        loss = loss_share(w, total, dp.world) * training_loss(
            spec, model, coords, t, y, w, train=True, generator=generator)
        loss.backward()
        value = sync_gradients_(dp, params, loss)
        transform()
        opt.step(lrs)
        ema_update(ema, params, ema_decay)
        return value

    return step


def validation_sums(dp: DPGroup, parts: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, ...]:
    """The ranks' shares of the validation sums, completed by one
    all_reduce (each part a tensor; returned in the same shapes)."""
    if not dp.joined:
        return tuple(parts)
    flat = _summed(dp, parts)
    out, off = [], 0
    for p in parts:
        out.append(flat[off:off + p.numel()].view_as(p))
        off += p.numel()
    return tuple(out)
