"""Spatio-temporal interpolation model (port of `st_dadk_tpu/models/st_interp.py`).

    input  [phi(s) spatial basis | psi(t) temporal basis]
    -> MLP: per hidden layer Linear -> LayerNorm -> ReLU -> Dropout
    -> head: Linear(out_dim), or the delta-reparameterised multi-quantile
       head beta = cumsum(delta), yhat_k = beta_k0 + h . beta_k(1:)

The first layer's spatial block runs through the fused basis kernels
(`ops.fused_first_layer`): h1 = phi(coords) @ W_s + psi(t) @ W_t + b, the
JAX package's `forward_train_fused` / `forward_inference_fused` path. Weights
keep the JAX layout: `mlp.linear_i.w` is (in, out), so W_s = w[:k_s] is a
contiguous row slice, and parameter names equal the JAX param-dict paths
(`from_jax_params` / `to_jax_params` carry params across).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.ops.basis import (temporal_basis_embed,
                                         temporal_grid_centers,
                                         uniform_grid_centers)
from st_dadk_tpu_torch.ops.fused_first_layer import fused_spatial_first_layer


@dataclass(frozen=True)
class ModelSpec:
    k_spatial_centers: Tuple[int, ...] = (25, 81, 121)
    k_temporal_centers: Tuple[int, ...] = (10, 15, 45)
    hidden_dims: Tuple[int, ...] = (256, 256, 128)
    dropout: float = 0.1
    layernorm: bool = True
    spatial_basis_function: str = "wendland"
    spatial_learnable: bool = False
    output_dim: int = 1
    use_delta_reparameterization: bool = False

    @property
    def k_spatial(self) -> int:
        return int(sum(self.k_spatial_centers))

    @property
    def k_temporal(self) -> int:
        return int(sum(self.k_temporal_centers))

    @property
    def input_dim(self) -> int:
        return self.k_spatial + self.k_temporal

    @property
    def delta_head(self) -> bool:
        return self.use_delta_reparameterization and self.output_dim > 1


def spec_from_config(cfg: ExperimentConfig) -> ModelSpec:
    """The model spec of a config. Raises NotImplementedError for what the
    port does not carry yet: ragged-k lanes and covariates need the masked
    phi kernels (pallas_basis.py), which are not ported, and the fused first
    layer needs a hidden layer; the trunk runs in float32 only."""
    if cfg.k_spatial_pad is not None:
        raise NotImplementedError(
            "ragged-k (k_spatial_pad) needs the masked phi kernels of "
            "pallas_basis.py, not ported yet")
    if cfg.p_covariates > 0:
        raise NotImplementedError(
            "covariates (p_covariates > 0) need the phi kernels of "
            "pallas_basis.py, not ported yet")
    if not cfg.hidden_dims:
        raise NotImplementedError("the fused first layer needs a hidden layer")
    if cfg.train_dtype == "bf16":
        raise NotImplementedError("the port trains in float32 only")
    return ModelSpec(
        k_spatial_centers=tuple(cfg.k_spatial_centers),
        k_temporal_centers=tuple(cfg.k_temporal_centers),
        hidden_dims=tuple(cfg.hidden_dims),
        dropout=cfg.dropout,
        layernorm=cfg.layernorm,
        spatial_basis_function=cfg.spatial_basis_function,
        spatial_learnable=cfg.spatial_learnable,
        output_dim=cfg.output_dim,
        use_delta_reparameterization=cfg.use_delta_reparameterization,
    )


class _Linear(nn.Module):
    """y = x @ w + b with w in (in, out) layout."""

    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(fan_in, fan_out))
        self.b = nn.Parameter(torch.empty(fan_out))


class _LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class _Basis(nn.Module):
    def __init__(self, centers: torch.Tensor, bandwidths: torch.Tensor):
        super().__init__()
        self.centers = nn.Parameter(centers.clone())
        self.log_bandwidths = nn.Parameter(torch.log(bandwidths))


class STInterp(nn.Module):
    """DA-STDK interpolation network. Parameters: `basis.{centers,
    log_bandwidths}` (learnable basis only), `mlp.linear_i.{w,b}`,
    `mlp.ln_i.{scale,bias}`, and `mlp.out.{w,b}` or `mlp.delta`. Buffers:
    the initial spatial centers/bandwidths and the temporal grid."""

    def __init__(self, spec: ModelSpec, spatial_centers: np.ndarray,
                 spatial_bandwidths: np.ndarray):
        super().__init__()
        if not spec.hidden_dims:
            raise NotImplementedError("the fused first layer needs a hidden layer")
        self.spec = spec
        centers = torch.tensor(np.asarray(spatial_centers, np.float32))
        bws = torch.tensor(np.asarray(spatial_bandwidths, np.float32))
        t_centers, t_bw = temporal_grid_centers(spec.k_temporal_centers)
        self.register_buffer("spatial_centers_init", centers.clone())
        self.register_buffer("spatial_bandwidths_init", bws.clone())
        self.register_buffer("temporal_centers", torch.as_tensor(t_centers))
        self.register_buffer("temporal_bandwidths", torch.as_tensor(t_bw))
        if spec.spatial_learnable:
            self.basis = _Basis(centers, bws)
        self.mlp = nn.Module()
        prev = spec.input_dim
        for i, h in enumerate(spec.hidden_dims):
            setattr(self.mlp, f"linear_{i}", _Linear(prev, h))
            if spec.layernorm:
                setattr(self.mlp, f"ln_{i}", _LayerNorm(h))
            prev = h
        if spec.delta_head:
            self.mlp.delta = nn.Parameter(torch.zeros(spec.output_dim, prev + 1))
        else:
            self.mlp.out = _Linear(prev, spec.output_dim)

    def spatial_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(centers, bandwidths); bandwidth = exp(log_bandwidth) when
        learnable."""
        if self.spec.spatial_learnable:
            return self.basis.centers, torch.exp(self.basis.log_bandwidths)
        return self.spatial_centers_init, self.spatial_bandwidths_init

    def forward(self, coords: torch.Tensor, t: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """yhat(s, t): (B, output_dim). Dropout (train=True, dropout > 0)
        draws one (B, sum(hidden)) uniform block from `generator`."""
        spec = self.spec
        centers, bandwidths = self.spatial_params()
        lin0 = self.mlp.linear_0
        k_s = spec.k_spatial
        h = fused_spatial_first_layer(coords, centers, bandwidths,
                                      lin0.w[:k_s], spec.spatial_basis_function)
        psi = temporal_basis_embed(t, self.temporal_centers,
                                   self.temporal_bandwidths)
        h = h + psi @ lin0.w[k_s:] + lin0.b
        return self.head(self.trunk_from_h1(h, train, generator))

    def _dropout_masks(self, n: int, generator: Optional[torch.Generator],
                       device: torch.device) -> list:
        if generator is None:
            raise ValueError("generator required for dropout in train mode")
        total = int(sum(self.spec.hidden_dims))
        keep = torch.rand((n, total), generator=generator,
                          device=device) < (1.0 - self.spec.dropout)
        masks, off = [], 0
        for hdim in self.spec.hidden_dims:
            masks.append(keep[:, off:off + hdim])
            off += hdim
        return masks

    def trunk_from_h1(self, h: torch.Tensor, train: bool,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
        """Hidden MLP given the first layer's pre-norm output."""
        spec = self.spec
        use_dropout = train and spec.dropout > 0.0
        masks = (self._dropout_masks(h.shape[0], generator, h.device)
                 if use_dropout else None)
        for i, hdim in enumerate(spec.hidden_dims):
            if i > 0:
                lin = getattr(self.mlp, f"linear_{i}")
                h = h @ lin.w + lin.b
            if spec.layernorm:
                ln = getattr(self.mlp, f"ln_{i}")
                h = torch.nn.functional.layer_norm(h, (hdim,), ln.scale,
                                                   ln.bias, eps=1e-5)
            h = torch.relu(h)
            if use_dropout:
                h = torch.where(masks[i], h / (1.0 - spec.dropout),
                                torch.zeros((), dtype=h.dtype, device=h.device))
        return h

    def head(self, h: torch.Tensor) -> torch.Tensor:
        if self.spec.delta_head:
            beta = torch.cumsum(self.mlp.delta, dim=0)          # (Q, d+1)
            return beta[None, :, 0] + h @ beta[:, 1:].T
        return h @ self.mlp.out.w + self.mlp.out.b

    # -- penalties --------------------------------------------------------------
    def domain_penalty(self, bounds: Tuple[float, float] = (0.0, 1.0)
                       ) -> torch.Tensor:
        """Squared violation of centers outside [0, 1]^2."""
        c = self.basis.centers
        lo, hi = bounds
        return torch.sum((torch.relu(lo - c) + torch.relu(c - hi)) ** 2)

    def movement_penalty(self) -> torch.Tensor:
        """Sum of squared center displacements from their init."""
        return torch.sum((self.basis.centers - self.spatial_centers_init) ** 2)

    def sparsity_penalty(self, penalty_type: str, lambda_l1: float,
                         lambda_group: float) -> Dict[str, torch.Tensor]:
        """First-layer sparsity penalties split by spatial/temporal rows."""
        w0 = self.mlp.linear_0.w
        if penalty_type == "none":
            zero = w0.new_zeros(())
            return {"spatial_penalty": zero, "temporal_penalty": zero,
                    "total_penalty": zero}
        if penalty_type not in ("element", "group", "sparse_group"):
            raise ValueError(f"Unknown penalty_type: {penalty_type}")
        k_s, k_t = self.spec.k_spatial, self.spec.k_temporal
        sp = sparsity_block(w0[:k_s], penalty_type, lambda_l1, lambda_group)
        tp = sparsity_block(w0[k_s:k_s + k_t], penalty_type, lambda_l1,
                            lambda_group)
        return {"spatial_penalty": sp, "temporal_penalty": tp,
                "total_penalty": sp + tp}


def sparsity_block(wb: torch.Tensor, penalty_type: str, lambda_l1: float,
                   lambda_group: float) -> torch.Tensor:
    """Sparsity penalty of one first-layer block (rows = basis functions).
    Exact-zero entries and rows get a zero gradient (guards of
    st_interp.py:431-449)."""
    def abs_l1(w: torch.Tensor) -> torch.Tensor:
        return torch.where(w != 0, torch.abs(w), torch.zeros_like(w)).sum()

    if penalty_type == "element":
        return lambda_l1 * abs_l1(wb)
    s = torch.sum(wb * wb, dim=1)
    nz = s > 0
    group = torch.sqrt(torch.where(nz, s, torch.ones_like(s))) * nz.to(wb.dtype)
    if penalty_type == "group":
        return lambda_group * group.sum()
    return lambda_group * group.sum() + lambda_l1 * abs_l1(wb)


def init_model(generator: torch.Generator, spec: ModelSpec,
               spatial_centers: Optional[np.ndarray] = None,
               spatial_bandwidths: Optional[np.ndarray] = None,
               device: torch.device | str = "cpu") -> STInterp:
    """Build and initialise the model like the JAX `init_model` (torch
    default Linear init U(+-1/sqrt(fan_in)), LayerNorm 1/0, delta ~
    N(0, 0.01)), drawing from a CPU `generator`; the centers default to the
    uniform multi-resolution grid."""
    if spatial_centers is None or spatial_bandwidths is None:
        spatial_centers, spatial_bandwidths = uniform_grid_centers(
            spec.k_spatial_centers)
    model = STInterp(spec, spatial_centers, spatial_bandwidths)
    with torch.no_grad():
        for i in range(len(spec.hidden_dims)):
            _linear_init(getattr(model.mlp, f"linear_{i}"), generator)
        if spec.delta_head:
            model.mlp.delta.copy_(0.01 * torch.randn(
                model.mlp.delta.shape, generator=generator))
        else:
            _linear_init(model.mlp.out, generator)
    return model.to(device)


def _linear_init(lin: _Linear, generator: torch.Generator) -> None:
    bound = 1.0 / float(np.sqrt(lin.w.shape[0]))
    lin.w.copy_((torch.rand(lin.w.shape, generator=generator) * 2 - 1) * bound)
    lin.b.copy_((torch.rand(lin.b.shape, generator=generator) * 2 - 1) * bound)


# ---------------------------------------------------------------------------
# Carrying params across packages (numpy nested dicts in the JAX layout)
# ---------------------------------------------------------------------------

def _flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def from_jax_params(spec: ModelSpec, params: Dict[str, Any],
                    consts: Dict[str, Any],
                    device: torch.device | str = "cpu") -> STInterp:
    """An STInterp holding a JAX (params, consts) pair's values."""
    model = STInterp(spec, np.asarray(consts["spatial_centers_init"]),
                     np.asarray(consts["spatial_bandwidths_init"]))
    load_jax_params(model, params)
    return model.to(device)


def load_jax_params(model: STInterp, params: Dict[str, Any]) -> None:
    flat = _flat(params)
    names = dict(model.named_parameters())
    if set(flat) != set(names):
        raise ValueError(f"param names differ: {sorted(set(flat) ^ set(names))}")
    with torch.no_grad():
        for name, p in names.items():
            p.copy_(torch.tensor(np.asarray(flat[name], np.float32)))


def to_jax_params(model: STInterp) -> Dict[str, Any]:
    """The model's parameters as a nested numpy dict in the JAX layout."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = p.detach().cpu().numpy().copy()
    return tree


def count_parameters(model: STInterp) -> int:
    return int(sum(p.numel() for p in model.parameters()))
