"""The plain reference of the spatio-temporal DeepKriging network, in
float32 PyTorch with no kernel, no lane axis and no fused layer.

    phi(s)   Wendland C4 of r = |s - c| / (bandwidth * calibration), r
             clamped at 1, distance guarded by sqrt(max(d^2, 1e-24))
    psi(t)   Gaussian RBF exp(-((t - c) / bw)^2 / 2) on multi-resolution
             1-D grids over [0, 1], bandwidth 2.5 x the grid's spacing
    MLP      [phi | psi] -> per hidden layer Linear -> LayerNorm(eps 1e-5)
             -> ReLU -> Dropout (keep / (1 - p)), then a Linear head

It follows the published description (ST-DADK, `stnf/models/st_interp.py`);
weights keep the (in, out) layout of the configuration's parameter names
(`mlp.linear_i.w`, `mlp.ln_i.scale`, `mlp.out.w`, `basis.centers`,
`basis.log_bandwidths`). It imports nothing of the program under test.

Every product goes through `mm`. The control of the benchmark's comparison
passes `tf32_mm`, the same products with both operands rounded to TF32 (10
mantissa bits, round to nearest even) and summed in float32: what a
float32 product computes on the card's tensor cores with TF32 allowed, in
the forward and in the backward's products alike.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (the low 13 mantissa bits cleared, to
    nearest even); inf and NaN pass through."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


class _TF32Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(to_tf32(a), to_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return (torch.matmul(g, to_tf32(b).transpose(-1, -2)),
                torch.matmul(to_tf32(a).transpose(-1, -2), g))


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _TF32Mm.apply(a, b)


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def uniform_grid(ks: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Regular sqrt(k) x sqrt(k) grids over [0, 1]^2, one a resolution,
    bandwidth 2.5 x the spacing: (centers (sum k, 2), bandwidths) float32."""
    cs, bws = [], []
    for k in ks:
        side = int(math.isqrt(int(k)))
        if side * side != k:
            raise ValueError(f"a grid resolution must be a square, got {k}")
        ax = np.linspace(0.0, 1.0, side)
        xx, yy = np.meshgrid(ax, ax, indexing="ij")
        cs.append(np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float32))
        bws.append(np.full(k, 2.5 * (1.0 / (side - 1) if side > 1 else 1.0),
                           np.float32))
    return np.concatenate(cs), np.concatenate(bws)


def temporal_grid(ks: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    cs, bws = [], []
    for n in ks:
        cs.append(np.linspace(0.0, 1.0, int(n)).astype(np.float32))
        bws.append(np.full(int(n), 2.5 * (1.0 / (n - 1) if n > 1 else 1.0),
                           np.float32))
    return np.concatenate(cs), np.concatenate(bws)


def wendland(r: torch.Tensor) -> torch.Tensor:
    r = torch.clamp(r, max=1.0)
    return (1.0 - r) ** 6 * (35.0 * r * r + 18.0 * r + 3.0) / 3.0


def phi(coords: torch.Tensor, centers: torch.Tensor,
        bandwidths: torch.Tensor) -> torch.Tensor:
    """(N, k) Wendland basis (calibration factor 1)."""
    dx = coords[:, 0:1] - centers[None, :, 0]
    dy = coords[:, 1:2] - centers[None, :, 1]
    d = torch.sqrt(torch.clamp(dx * dx + dy * dy, min=1e-24))
    return wendland(d / bandwidths[None, :])


def psi(t: torch.Tensor, centers: torch.Tensor,
        bandwidths: torch.Tensor) -> torch.Tensor:
    diff = (t.reshape(-1, 1) - centers[None, :]) / bandwidths[None, :]
    return torch.exp(-0.5 * diff * diff)


class Net:
    """The network's structure: which parameters it has and in what
    order."""

    def __init__(self, k_spatial: Sequence[int], k_temporal: Sequence[int],
                 hidden: Sequence[int], out_dim: int, learnable: bool,
                 dropout: float, device):
        self.k_spatial, self.hidden = list(k_spatial), list(hidden)
        self.out_dim, self.learnable = int(out_dim), bool(learnable)
        self.dropout = float(dropout)
        tc, tbw = temporal_grid(k_temporal)
        self.t_centers = torch.as_tensor(tc, device=device)
        self.t_bw = torch.as_tensor(tbw, device=device)
        self.ks, self.kt = int(sum(k_spatial)), len(tc)

    def names(self) -> Tuple[str, ...]:
        """Parameter names in the order the network registers them."""
        out = ["basis.centers", "basis.log_bandwidths"] if self.learnable \
            else []
        for i in range(len(self.hidden)):
            out += [f"mlp.linear_{i}.w", f"mlp.linear_{i}.b",
                    f"mlp.ln_{i}.scale", f"mlp.ln_{i}.bias"]
        return tuple(out + ["mlp.out.w", "mlp.out.b"])

    def init_weights(self, seed: int, device) -> Dict[str, torch.Tensor]:
        """The weights' initial draw (the ST-DADK reference's torch Linear
        default, U(+-1/sqrt(fan_in)) for w then b a layer, head last;
        LayerNorm 1 and 0), from a CPU generator seeded with the
        experiment seed."""
        g = torch.Generator().manual_seed(int(seed))
        out: Dict[str, torch.Tensor] = {}
        widths = [self.ks + self.kt, *self.hidden]

        def linear(name, fan_in, fan_out):
            bound = 1.0 / float(np.sqrt(fan_in))
            out[name + ".w"] = (torch.rand((fan_in, fan_out), generator=g)
                                * 2 - 1) * bound
            out[name + ".b"] = (torch.rand((fan_out,), generator=g)
                                * 2 - 1) * bound

        for i, h in enumerate(self.hidden):
            linear(f"mlp.linear_{i}", widths[i], h)
            out[f"mlp.ln_{i}.scale"] = torch.ones(h)
            out[f"mlp.ln_{i}.bias"] = torch.zeros(h)
        linear("mlp.out", widths[-1], self.out_dim)
        return {k: v.to(device) for k, v in out.items()}

    def basis(self, params: Dict[str, torch.Tensor],
              consts: Dict[str, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.learnable:
            return params["basis.centers"], \
                torch.exp(params["basis.log_bandwidths"])
        return consts["centers"], consts["bandwidths"]

    def forward(self, params: Dict[str, torch.Tensor],
                consts: Dict[str, torch.Tensor], coords: torch.Tensor,
                t: torch.Tensor, keep: Optional[torch.Tensor] = None,
                mm: Mm = f32_mm) -> torch.Tensor:
        """(N, out_dim). `keep` (N, sum(hidden)) bool: dropout's keep mask
        of a training step, None in evaluation."""
        centers, bws = self.basis(params, consts)
        h = mm(torch.cat([phi(coords, centers, bws),
                          psi(t, self.t_centers, self.t_bw)], dim=1),
               params["mlp.linear_0.w"]) + params["mlp.linear_0.b"]
        off = 0
        for i, width in enumerate(self.hidden):
            if i > 0:
                h = mm(h, params[f"mlp.linear_{i}.w"]) \
                    + params[f"mlp.linear_{i}.b"]
            mu = h.mean(dim=1, keepdim=True)
            var = ((h - mu) ** 2).mean(dim=1, keepdim=True)
            h = (h - mu) / torch.sqrt(var + 1e-5)
            h = h * params[f"mlp.ln_{i}.scale"] + params[f"mlp.ln_{i}.bias"]
            h = torch.relu(h)
            if keep is not None and self.dropout > 0:
                h = torch.where(keep[:, off:off + width],
                                h / (1.0 - self.dropout),
                                torch.zeros_like(h))
            off += width
        return mm(h, params["mlp.out.w"]) + params["mlp.out.b"]

    def predict(self, params, consts, coords: torch.Tensor, t: torch.Tensor,
                block: int = 65536, mm: Mm = f32_mm) -> torch.Tensor:
        """Evaluation in blocks of `block` points, so that it fits."""
        with torch.no_grad():
            return torch.cat([self.forward(params, consts, coords[s:s + block],
                                           t[s:s + block], None, mm)
                              for s in range(0, coords.shape[0], block)])
