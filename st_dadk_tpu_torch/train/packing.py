"""Flat parameter groups for the optimizer step (port of
`st_dadk_tpu/train/packing.py`).

The model has about 16 small parameter leaves (basis centers and
log-bandwidths, each layer's Linear and LayerNorm, the head). The per-leaf
AdamW, EMA, masking and clipping of a step launch one eager kernel a leaf
and an op, and the step is host-bound on the card. Packing each parameter
GROUP into one flat float32 buffer turns that into the same ops on two
buffers:

  - group 'basis' (if spatial_learnable): centers, then log-bandwidths;
  - group 'mlp': every other leaf, in JAX's tree-flatten order (sorted
    keys at every level of the param dict).

The groups are the optimizer's two (per-group LR, the basis group's 0.1x
clip), so the fit runs `AdamW` / `AdamWLanes`, `ema_update(_lanes)` and
the clipping of `train/optimizer.py` on the group buffers as they are:
elementwise the packed step is bitwise the per-leaf one, and only the
clip's norm sums in another order (which JAX accepts, packing.py:17-21).

A group buffer is (P,) for a single fit or (M, P) for M lanes. Every
`nn.Parameter` of the model becomes a view into its group's buffer, and its
`.grad` a view into the gradient buffer, which `backward` accumulates into
in place: the fit zeroes the gradient buffer, never sets `.grad` to None
(autograd would then allocate a fresh tensor and the buffer would go stale).
A lane leaf's view `buf[:, a:b].view(M, ...)` is strided, which autograd
reports once as a gradient layout contract warning; that message is
filtered (`bind_grads`). Checkpoints, `FitResult` and the finalize pulls
keep the structured layout (`views`, `pack`), as in JAX (packing.py:23-25).
"""
from __future__ import annotations

import warnings
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# the optimizer's groups, in the order of its LR columns
GROUPS = ("mlp", "basis")
# autograd's note on a strided `.grad` view of a lane leaf (module docstring)
_LAYOUT_WARNING = "grad and param do not obey the gradient layout contract"


def _group_of(name: str) -> str:
    return "basis" if name.split(".")[0] == "basis" else "mlp"


def _shares(t: torch.Tensor, buf: torch.Tensor) -> bool:
    return t.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()


class PackSpec:
    """The leaf layout of a model's parameters in the two group buffers.
    `names` are the parameter names in the module's order, `shapes` their
    shapes without a lane dimension."""

    def __init__(self, names: Sequence[str],
                 shapes: Sequence[Tuple[int, ...]]):
        self.names = tuple(names)
        sizes = {g: 0 for g in GROUPS}
        self.slots: Dict[str, Tuple[str, int, int, Tuple[int, ...]]] = {}
        for name, shape in sorted(zip(names, shapes),
                                  key=lambda ns: ns[0].split(".")):
            g, n = _group_of(name), int(np.prod(shape))
            self.slots[name] = (g, sizes[g], n, tuple(shape))
            sizes[g] += n
        self.groups = tuple(g for g in GROUPS if sizes[g])
        self.group_sizes = {g: sizes[g] for g in self.groups}

    @classmethod
    def for_model(cls, model: nn.Module) -> "PackSpec":
        """The layout of an `STInterp` or, without its lane dimension, an
        `STInterpLanes`."""
        lead = 1 if hasattr(model, "lanes") else 0
        named = list(model.named_parameters())
        return cls([n for n, _ in named], [tuple(p.shape[lead:])
                                           for _, p in named])

    def views(self, bufs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each leaf as a view into its group buffer, in the module's
        order; a buffer's leading dimensions (lanes) lead every view."""
        out = {}
        for name in self.names:
            g, off, n, shape = self.slots[name]
            buf = bufs[g]
            out[name] = buf[..., off:off + n].view(*buf.shape[:-1], *shape)
        return out

    def pack(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Structured leaves {name: (..., *shape)} -> fresh group buffers
        {group: (..., P)}."""
        parts: Dict[str, list] = {g: [] for g in self.groups}
        for name in sorted(self.names, key=lambda nm: self.slots[nm][1]):
            g, _, _, shape = self.slots[name]
            x = leaves[name]
            parts[g].append(x.reshape(*x.shape[:x.dim() - len(shape)], -1))
        return {g: torch.cat(ps, dim=-1) for g, ps in parts.items()}

    def bind(self, module: nn.Module, bufs: Dict[str, torch.Tensor]) -> None:
        """Make each parameter of `module` a view into `bufs`, whose values
        it then holds."""
        views = self.views(bufs)
        for name, p in module.named_parameters():
            p.data = views[name]

    def bind_grads(self, module: nn.Module,
                   grads: Dict[str, torch.Tensor]) -> None:
        """Make each parameter's `.grad` a view into `grads`."""
        warnings.filterwarnings("ignore", message=_LAYOUT_WARNING)
        views = self.views(grads)
        for name, p in module.named_parameters():
            p.grad = views[name]

    def params_are_views(self, module: nn.Module,
                         bufs: Dict[str, torch.Tensor]) -> bool:
        """Whether every parameter of `module` lies in its group buffer."""
        return all(_shares(p, bufs[self.slots[name][0]])
                   for name, p in module.named_parameters())

    def grads_are_views(self, module: nn.Module,
                        grads: Dict[str, torch.Tensor]) -> bool:
        """Whether every parameter's `.grad` is still a view of `grads`."""
        return all(p.grad is not None
                   and _shares(p.grad, grads[self.slots[name][0]])
                   for name, p in module.named_parameters())

    def attach(self, module: nn.Module,
               with_grads: bool = True) -> Dict[str, torch.Tensor]:
        """Move `module`'s parameters into fresh group buffers (values
        kept) and make them views; with `with_grads`, zeroed gradient
        buffers too, each the `.grad` of its parameter buffer."""
        bufs = self.pack({n: p.detach() for n, p in module.named_parameters()})
        self.bind(module, bufs)
        if with_grads:
            grads = {g: torch.zeros_like(b) for g, b in bufs.items()}
            self.bind_grads(module, grads)
            for g, b in bufs.items():
                b.grad = grads[g]
        return bufs
