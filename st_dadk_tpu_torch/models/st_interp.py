"""Spatio-temporal interpolation model (port of `st_dadk_tpu/models/st_interp.py`).

    input  [X covariates (p) | phi(s) spatial basis | psi(t) temporal basis]
    -> MLP: per hidden layer Linear -> LayerNorm -> ReLU -> Dropout
    -> head: Linear(out_dim), or the delta-reparameterised multi-quantile
       head beta = cumsum(delta), yhat_k = beta_k0 + h . beta_k(1:)

The first layer takes one of two kernel routes (`ModelSpec.phi_route`):

  - fused (the default): h1 = phi(coords) @ W_s + psi(t) @ W_t + b through
    the fused basis kernels (`ops.fused_first_layer`), the JAX package's
    `forward_train_fused` / `forward_inference_fused`; phi never reaches
    device memory;
  - materialised phi: phi (N, k) from the spatial-basis kernels
    (`ops.spatial_basis_kernels`), times `spatial_k_mask` on a ragged-k lane,
    then [X | phi | psi] @ W + b: the JAX `_embed` + `forward` path. Ragged-k
    lanes, covariates, `use_pallas_training` and a model with no hidden layer
    (`hidden_dims: []`, whose head reads [X | phi | psi] directly, JAX
    st_interp.py:89 and :388-389) take it.

Weights keep the JAX layout: `mlp.linear_i.w` is (in, out), so W_s =
w[p:p+k_s] is a contiguous row slice, and parameter names equal the JAX
param-dict paths (`from_jax_params` / `to_jax_params` carry params across;
`pad_lane_model` / `strip_lane_padding` pad a lane to a shared width and
back).

`STInterpLanes` is M such models of one spec as one module: every parameter
and per-lane buffer carries a leading lane dimension, the first layer goes
through the lane axis of the fused kernels or, on the materialised-phi
route, of the spatial-basis kernels with each lane's column mask (one launch
for all lanes either way), and the other layers through `torch.baddbmm`. `stack_lane_models` builds it from
M `STInterp`s and `lane_params` gives lane i's weights back in the JAX
layout, so weights cross lane by lane through `from_jax_params` /
`to_jax_params`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.ops.basis import (temporal_basis_embed,
                                         temporal_grid_centers,
                                         uniform_grid_centers)
from st_dadk_tpu_torch.ops.fused_first_layer import fused_spatial_first_layer
from st_dadk_tpu_torch.ops.spatial_basis_kernels import \
    spatial_basis_embed_kernel


@dataclass(frozen=True)
class ModelSpec:
    p: int = 0
    k_spatial_centers: Tuple[int, ...] = (25, 81, 121)
    k_temporal_centers: Tuple[int, ...] = (10, 15, 45)
    hidden_dims: Tuple[int, ...] = (256, 256, 128)
    dropout: float = 0.1
    layernorm: bool = True
    spatial_basis_function: str = "wendland"
    spatial_learnable: bool = False
    output_dim: int = 1
    use_delta_reparameterization: bool = False
    # the training and validation forward builds phi (N, k) on its own
    # (the materialised-phi route) instead of the fused first layer
    phi_route: bool = False
    # a ragged-k lane (k_spatial_pad): padded during the fit and stripped for
    # evaluation, it never takes the fused kernels, whose phi has no mask
    padded_lane: bool = False

    @property
    def k_spatial(self) -> int:
        return int(sum(self.k_spatial_centers))

    @property
    def k_temporal(self) -> int:
        return int(sum(self.k_temporal_centers))

    @property
    def input_dim(self) -> int:
        return self.p + self.k_spatial + self.k_temporal

    @property
    def last_hidden_dim(self) -> int:
        """The head's input width: the last hidden layer's, or the feature
        width of a model with no hidden layer."""
        return self.hidden_dims[-1] if self.hidden_dims else self.input_dim

    @property
    def fused_predict(self) -> bool:
        """Whether dense predict takes the fused forward: with no
        covariates, off a padded lane (JAX loop.py:1348, where `use_pallas`
        is off for ragged lanes) and with a first hidden layer to fuse."""
        return self.p == 0 and not self.padded_lane and bool(self.hidden_dims)

    @property
    def delta_head(self) -> bool:
        return self.use_delta_reparameterization and self.output_dim > 1


def spec_from_config(cfg: ExperimentConfig) -> ModelSpec:
    """The model spec of a config. A ragged-k lane (`k_spatial_pad`) sees
    one padded resolution of k_spatial_pad centers, as in JAX; its real
    layout stays in the config (init, finalize). The first layer takes the
    materialised-phi route for a ragged lane, for covariates, for a model
    with no hidden layer (no first layer to fuse phi into) and for
    `use_pallas_training` without `use_fused_training` (the order of JAX
    `forward` :388 and `_embed` :226), and the fused route otherwise.
    Raises NotImplementedError for the bf16 trunk, which the port does not
    carry."""
    if cfg.train_dtype == "bf16":
        raise NotImplementedError("the port trains in float32 only")
    ragged = cfg.k_spatial_pad is not None
    return ModelSpec(
        p=cfg.p_covariates,
        k_spatial_centers=((int(cfg.k_spatial_pad),) if ragged
                           else tuple(cfg.k_spatial_centers)),
        k_temporal_centers=tuple(cfg.k_temporal_centers),
        hidden_dims=tuple(cfg.hidden_dims),
        dropout=cfg.dropout,
        layernorm=cfg.layernorm,
        spatial_basis_function=cfg.spatial_basis_function,
        spatial_learnable=cfg.spatial_learnable,
        output_dim=cfg.output_dim,
        use_delta_reparameterization=cfg.use_delta_reparameterization,
        phi_route=(ragged or cfg.p_covariates > 0 or not cfg.hidden_dims
                   or (cfg.use_pallas_training and not cfg.use_fused_training)),
        padded_lane=ragged,
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
    the initial spatial centers/bandwidths, the temporal grid and, on a
    padded ragged-k lane, `spatial_k_mask` (1 for the real centers in the
    leading rows, 0 for the junk rows after them)."""

    def __init__(self, spec: ModelSpec, spatial_centers: np.ndarray,
                 spatial_bandwidths: np.ndarray,
                 spatial_k_mask: Optional[np.ndarray] = None):
        super().__init__()
        self.spec = spec
        centers = torch.tensor(np.asarray(spatial_centers, np.float32))
        bws = torch.tensor(np.asarray(spatial_bandwidths, np.float32))
        t_centers, t_bw = temporal_grid_centers(spec.k_temporal_centers)
        self.register_buffer("spatial_centers_init", centers.clone())
        self.register_buffer("spatial_bandwidths_init", bws.clone())
        self.register_buffer("temporal_centers", torch.as_tensor(t_centers))
        self.register_buffer("temporal_bandwidths", torch.as_tensor(t_bw))
        mask = None
        if spatial_k_mask is not None:
            mask = torch.tensor(np.asarray(spatial_k_mask, np.float32))
            if tuple(mask.shape) != (spec.k_spatial,):
                raise ValueError(f"spatial_k_mask shape {tuple(mask.shape)} "
                                 f"!= ({spec.k_spatial},)")
        self.register_buffer("spatial_k_mask", mask)
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
                X: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                fused: Optional[bool] = None) -> torch.Tensor:
        """yhat(s, t): (B, output_dim). `X` (B, p) are the covariates of a
        model with p > 0. `fused` picks the first layer's route (default:
        the spec's). Dropout (train=True, dropout > 0) draws one
        (B, sum(hidden)) uniform block from `generator`; a model with no
        hidden layer feeds the features to the head and draws nothing."""
        if fused is None:
            fused = not self.spec.phi_route
        if not self.spec.hidden_dims:
            if fused:
                raise ValueError("a model with no hidden layer has no first "
                                 "layer to fuse")
            return self.head(self.features(coords, t, X))
        h = self.first_layer(coords, t, X, fused)
        return self.head(self.trunk_from_h1(h, train, generator))

    def features(self, coords: torch.Tensor, t: torch.Tensor,
                 X: Optional[torch.Tensor]) -> torch.Tensor:
        """[X | phi | psi] (B, input_dim) with phi from the materialised-phi
        kernels (JAX `_embed`)."""
        spec = self.spec
        centers, bandwidths = self.spatial_params()
        psi = temporal_basis_embed(t, self.temporal_centers,
                                   self.temporal_bandwidths)
        phi = spatial_basis_embed_kernel(coords, centers, bandwidths,
                                         spec.spatial_basis_function)
        if self.spatial_k_mask is not None:
            # junk columns are zero, so neither their weight rows nor the
            # junk centers get a gradient (JAX st_interp.py:233-238)
            phi = phi * self.spatial_k_mask
        if spec.p > 0:
            if X is None:
                raise ValueError(f"the model takes p={spec.p} covariates: "
                                 f"pass X (B, {spec.p})")
            return torch.cat([X, phi, psi], dim=-1)
        return torch.cat([phi, psi], dim=-1)

    def first_layer(self, coords: torch.Tensor, t: torch.Tensor,
                    X: Optional[torch.Tensor], fused: bool) -> torch.Tensor:
        """The first layer's pre-norm output h1 (B, H1) on either route."""
        spec = self.spec
        lin0 = self.mlp.linear_0
        if fused:
            if spec.p > 0 or self.spatial_k_mask is not None:
                raise ValueError("the fused first layer takes neither "
                                 "covariates nor a column mask")
            centers, bandwidths = self.spatial_params()
            psi = temporal_basis_embed(t, self.temporal_centers,
                                       self.temporal_bandwidths)
            k_s = spec.k_spatial
            h = fused_spatial_first_layer(coords, centers, bandwidths,
                                          lin0.w[:k_s],
                                          spec.spatial_basis_function)
            return h + psi @ lin0.w[k_s:] + lin0.b
        return self.features(coords, t, X) @ lin0.w + lin0.b

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
        """First-layer sparsity penalties split by spatial/temporal rows
        (after the p covariate rows). A model with no hidden layer has no
        first layer to penalise: any penalty but 'none' raises, where JAX
        fails on the missing `linear_0`."""
        if penalty_type == "none":
            zero = next(self.mlp.parameters()).new_zeros(())
            return {"spatial_penalty": zero, "temporal_penalty": zero,
                    "total_penalty": zero}
        if penalty_type not in ("element", "group", "sparse_group"):
            raise ValueError(f"Unknown penalty_type: {penalty_type}")
        if not self.spec.hidden_dims:
            raise ValueError(f"sparsity penalty {penalty_type!r} needs a first "
                             "hidden layer; this model has none")
        w0 = self.mlp.linear_0.w
        p, k_s, k_t = self.spec.p, self.spec.k_spatial, self.spec.k_temporal
        sp = sparsity_block(w0[p:p + k_s], penalty_type, lambda_l1,
                            lambda_group)
        tp = sparsity_block(w0[p + k_s:p + k_s + k_t], penalty_type, lambda_l1,
                            lambda_group)
        return {"spatial_penalty": sp, "temporal_penalty": tp,
                "total_penalty": sp + tp}


def sparsity_block(wb: torch.Tensor, penalty_type: str, lambda_l1: float,
                   lambda_group: float, lanes: bool = False) -> torch.Tensor:
    """Sparsity penalty of one first-layer block (rows = basis functions).
    Exact-zero entries and rows get a zero gradient (guards of
    st_interp.py:431-449). With `lanes`, wb is (M, rows, H) and the penalty
    (M,), a lane each."""
    def total(x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=tuple(range(1, x.dim()))) if lanes else x.sum()

    def abs_l1(w: torch.Tensor) -> torch.Tensor:
        return total(torch.where(w != 0, torch.abs(w), torch.zeros_like(w)))

    if penalty_type == "element":
        return lambda_l1 * abs_l1(wb)
    s = torch.sum(wb * wb, dim=-1)
    nz = s > 0
    group = torch.sqrt(torch.where(nz, s, torch.ones_like(s))) * nz.to(wb.dtype)
    if penalty_type == "group":
        return lambda_group * total(group)
    return lambda_group * total(group) + lambda_l1 * abs_l1(wb)


# ---------------------------------------------------------------------------
# M models of one spec as lanes of one module
# ---------------------------------------------------------------------------


class _LinearLanes(nn.Module):
    def __init__(self, lanes: int, fan_in: int, fan_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(lanes, fan_in, fan_out))
        self.b = nn.Parameter(torch.empty(lanes, fan_out))


class _LayerNormLanes(nn.Module):
    def __init__(self, lanes: int, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(lanes, dim))
        self.bias = nn.Parameter(torch.zeros(lanes, dim))


class STInterpLanes(nn.Module):
    """M DA-STDK networks of one `ModelSpec` as lanes of one module.

    Parameters have `STInterp`'s names with a leading lane dimension M:
    `basis.centers` (M, k, 2), `basis.log_bandwidths` (M, k),
    `mlp.linear_i.w` (M, in, out), `.b` (M, out), `mlp.ln_i.{scale,bias}`
    (M, h), `mlp.out.{w,b}` or `mlp.delta` (M, Q, d + 1); so have the buffers
    `spatial_centers_init` (M, k, 2) and `spatial_bandwidths_init` (M, k).
    Lanes share no parameter, so a sum of lane losses gives each lane its
    own gradient. A spec on the materialised-phi route (ragged-k lanes,
    covariates, `use_pallas_training`) builds phi (M, B, k) with the lane
    spatial-basis kernel, then [X | phi | psi] @ W by `torch.baddbmm`. A
    `padded_lane` spec holds the buffer `spatial_k_mask` (M, k), 1 on each
    lane's real centers and 0 on the junk rows after them: the kernels zero
    phi's junk columns and their gradients, so lanes of different real
    widths share one program and their junk rows stay exactly 0."""

    def __init__(self, spec: ModelSpec, spatial_centers: np.ndarray,
                 spatial_bandwidths: np.ndarray,
                 spatial_k_mask: Optional[np.ndarray] = None):
        super().__init__()
        self.spec = spec
        centers = torch.tensor(np.asarray(spatial_centers, np.float32))
        bws = torch.tensor(np.asarray(spatial_bandwidths, np.float32))
        if (centers.dim() != 3 or tuple(centers.shape[1:])
                != (spec.k_spatial, 2)
                or tuple(bws.shape) != tuple(centers.shape[:2])):
            raise ValueError(f"lane centers {tuple(centers.shape)} / bandwidths "
                             f"{tuple(bws.shape)}: expected (M, "
                             f"{spec.k_spatial}, 2) / (M, {spec.k_spatial})")
        M = self.lanes = centers.shape[0]
        mask = None
        if spec.padded_lane != (spatial_k_mask is not None):
            raise ValueError("a padded-lane spec takes spatial_k_mask "
                             "(M, k), any other spec none")
        if spatial_k_mask is not None:
            mask = torch.tensor(np.asarray(spatial_k_mask, np.float32))
            if tuple(mask.shape) != (M, spec.k_spatial):
                raise ValueError(f"spatial_k_mask shape {tuple(mask.shape)} "
                                 f"!= ({M}, {spec.k_spatial})")
        t_centers, t_bw = temporal_grid_centers(spec.k_temporal_centers)
        self.register_buffer("spatial_centers_init", centers.clone())
        self.register_buffer("spatial_bandwidths_init", bws.clone())
        self.register_buffer("temporal_centers", torch.as_tensor(t_centers))
        self.register_buffer("temporal_bandwidths", torch.as_tensor(t_bw))
        self.register_buffer("spatial_k_mask", mask)
        if spec.spatial_learnable:
            self.basis = _Basis(centers, bws)
        self.mlp = nn.Module()
        prev = spec.input_dim
        for i, h in enumerate(spec.hidden_dims):
            setattr(self.mlp, f"linear_{i}", _LinearLanes(M, prev, h))
            if spec.layernorm:
                setattr(self.mlp, f"ln_{i}", _LayerNormLanes(M, h))
            prev = h
        if spec.delta_head:
            self.mlp.delta = nn.Parameter(
                torch.zeros(M, spec.output_dim, prev + 1))
        else:
            self.mlp.out = _LinearLanes(M, prev, spec.output_dim)

    def spatial_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.spec.spatial_learnable:
            return self.basis.centers, torch.exp(self.basis.log_bandwidths)
        return self.spatial_centers_init, self.spatial_bandwidths_init

    def forward(self, coords: torch.Tensor, t: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                X: Optional[torch.Tensor] = None) -> torch.Tensor:
        """yhat: coords (M, B, 2), t (M, B, 1) -> (M, B, output_dim), lane
        i from lane i's weights. `X` (M, B, p) are the covariates of a model
        with p > 0. Dropout (train=True, dropout > 0) draws one
        (M, B, sum(hidden)) uniform block from `generator` for all lanes; a
        model with no hidden layer feeds [X | phi | psi] to the head and
        draws nothing."""
        spec = self.spec
        M, B = coords.shape[0], coords.shape[1]
        if M != self.lanes or tuple(t.shape) != (M, B, 1):
            raise ValueError(f"coords {tuple(coords.shape)} / t "
                             f"{tuple(t.shape)}: expected ({self.lanes}, B, 2) "
                             f"/ ({self.lanes}, B, 1)")
        centers, bandwidths = self.spatial_params()
        k_s = spec.k_spatial
        psi = temporal_basis_embed(t, self.temporal_centers,
                                   self.temporal_bandwidths).reshape(M, B, -1)
        lin0 = getattr(self.mlp, "linear_0", None)     # None: no hidden layer
        if spec.phi_route:
            # junk columns are zero inside the kernels, so neither their
            # weight rows nor the junk centers get a gradient (JAX
            # st_interp.py:233-238 multiplies after its kernel)
            phi = spatial_basis_embed_kernel(
                coords, centers, bandwidths, spec.spatial_basis_function,
                mask=self.spatial_k_mask)
            if spec.p > 0:
                if X is None:
                    raise ValueError(f"the model takes p={spec.p} covariates: "
                                     f"pass X (M, B, {spec.p})")
                feats = torch.cat([X, phi, psi], dim=-1)
            else:
                feats = torch.cat([phi, psi], dim=-1)
            h = (feats if lin0 is None
                 else torch.baddbmm(lin0.b[:, None, :], feats, lin0.w))
        else:
            h = fused_spatial_first_layer(coords, centers, bandwidths,
                                          lin0.w[:, :k_s],
                                          spec.spatial_basis_function)
            h = h + torch.baddbmm(lin0.b[:, None, :], psi, lin0.w[:, k_s:])

        use_dropout = train and spec.dropout > 0.0 and bool(spec.hidden_dims)
        if use_dropout:
            if generator is None:
                raise ValueError("generator required for dropout in train mode")
            keep = torch.rand((M, B, int(sum(spec.hidden_dims))),
                              generator=generator,
                              device=h.device) < (1.0 - spec.dropout)
        off = 0
        for i, hdim in enumerate(spec.hidden_dims):
            if i > 0:
                lin = getattr(self.mlp, f"linear_{i}")
                h = torch.baddbmm(lin.b[:, None, :], h, lin.w)
            if spec.layernorm:
                ln = getattr(self.mlp, f"ln_{i}")
                h = torch.nn.functional.layer_norm(h, (hdim,), eps=1e-5)
                h = h * ln.scale[:, None, :] + ln.bias[:, None, :]
            h = torch.relu(h)
            if use_dropout:
                h = torch.where(keep[..., off:off + hdim],
                                h / (1.0 - spec.dropout),
                                torch.zeros((), dtype=h.dtype, device=h.device))
            off += hdim
        if spec.delta_head:
            beta = torch.cumsum(self.mlp.delta, dim=1)          # (M, Q, d+1)
            return (beta[:, None, :, 0]
                    + torch.bmm(h, beta[:, :, 1:].transpose(1, 2)))
        return torch.baddbmm(self.mlp.out.b[:, None, :], h, self.mlp.out.w)

    # -- penalties, (M,) each ---------------------------------------------------
    def domain_penalty(self, bounds: Tuple[float, float] = (0.0, 1.0)
                       ) -> torch.Tensor:
        c = self.basis.centers
        lo, hi = bounds
        return torch.sum((torch.relu(lo - c) + torch.relu(c - hi)) ** 2,
                         dim=(1, 2))

    def movement_penalty(self) -> torch.Tensor:
        return torch.sum((self.basis.centers - self.spatial_centers_init) ** 2,
                         dim=(1, 2))

    def sparsity_penalty(self, penalty_type: str, lambda_l1: float,
                         lambda_group: float) -> Dict[str, torch.Tensor]:
        if penalty_type == "none":
            zero = next(self.mlp.parameters()).new_zeros((self.lanes,))
            return {"spatial_penalty": zero, "temporal_penalty": zero,
                    "total_penalty": zero}
        if penalty_type not in ("element", "group", "sparse_group"):
            raise ValueError(f"Unknown penalty_type: {penalty_type}")
        if not self.spec.hidden_dims:
            raise ValueError(f"sparsity penalty {penalty_type!r} needs a first "
                             "hidden layer; this model has none")
        w0 = self.mlp.linear_0.w
        p, k_s, k_t = self.spec.p, self.spec.k_spatial, self.spec.k_temporal
        sp = sparsity_block(w0[:, p:p + k_s], penalty_type, lambda_l1,
                            lambda_group, lanes=True)
        tp = sparsity_block(w0[:, p + k_s:p + k_s + k_t], penalty_type,
                            lambda_l1, lambda_group, lanes=True)
        return {"spatial_penalty": sp, "temporal_penalty": tp,
                "total_penalty": sp + tp}


def stack_lane_models(models: Sequence[STInterp]) -> STInterpLanes:
    """One `STInterpLanes` holding the given models' weights and init
    buffers, lane i from models[i], on their device. They must share a
    spec; padded ragged-k lanes share their padded spec and bring each its
    own `spatial_k_mask`."""
    if not models:
        raise ValueError("stack_lane_models: no models")
    spec = models[0].spec
    if any(m.spec != spec for m in models):
        raise ValueError("stack_lane_models: the models' specs differ")
    masks = [m.spatial_k_mask for m in models]
    if any((mk is None) == spec.padded_lane for mk in masks):
        raise ValueError("stack_lane_models: a padded lane needs its "
                         "spatial_k_mask, any other model none")
    lanes = STInterpLanes(
        spec,
        np.stack([m.spatial_centers_init.detach().cpu().numpy()
                  for m in models]),
        np.stack([m.spatial_bandwidths_init.detach().cpu().numpy()
                  for m in models]),
        (np.stack([mk.detach().cpu().numpy() for mk in masks])
         if spec.padded_lane else None))
    lanes = lanes.to(next(models[0].parameters()).device)
    per_lane = [dict(m.named_parameters()) for m in models]
    with torch.no_grad():
        for name, p in lanes.named_parameters():
            p.copy_(torch.stack([d[name].detach() for d in per_lane]))
    return lanes


def lane_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """A flat {dotted name: array} dict as the nested JAX-layout dict."""
    tree: Dict[str, Any] = {}
    for name, v in flat.items():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def lane_params(lanes_model: STInterpLanes, i: int) -> Dict[str, Any]:
    """Lane i's parameters as a nested numpy dict in the JAX layout."""
    return lane_tree({name: p.detach()[i].cpu().numpy().copy()
                      for name, p in lanes_model.named_parameters()})


def init_model(generator: torch.Generator, spec: ModelSpec,
               spatial_centers: Optional[np.ndarray] = None,
               spatial_bandwidths: Optional[np.ndarray] = None,
               device: torch.device | str = "cuda") -> STInterp:
    """Build and initialise the model like the JAX `init_model` (torch
    default Linear init U(+-1/sqrt(fan_in)), LayerNorm 1/0, delta ~
    N(0, 0.01)), drawing from a CPU `generator`, and move it to `device`
    (the card unless the caller names the CPU); the centers default to the
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
                    device: torch.device | str = "cuda") -> STInterp:
    """An STInterp holding a JAX (params, consts) pair's values on `device`
    (the card unless the caller names the CPU); a padded lane's
    `spatial_k_mask` in consts becomes the model's mask."""
    mask = consts.get("spatial_k_mask")
    model = STInterp(spec, np.asarray(consts["spatial_centers_init"]),
                     np.asarray(consts["spatial_bandwidths_init"]),
                     None if mask is None else np.asarray(mask))
    load_jax_params(model, params)
    return model.to(device)


def model_consts(model: STInterp) -> Dict[str, np.ndarray]:
    """The model's buffers as the JAX consts dict (numpy)."""
    names = ["spatial_centers_init", "spatial_bandwidths_init",
             "temporal_centers", "temporal_bandwidths"]
    if model.spatial_k_mask is not None:
        names.append("spatial_k_mask")
    return {nm: getattr(model, nm).detach().cpu().numpy().copy()
            for nm in names}


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
    return lane_tree({name: p.detach().cpu().numpy().copy()
                      for name, p in model.named_parameters()})


def count_parameters(model: STInterp) -> int:
    return int(sum(p.numel() for p in model.parameters()))


# ---------------------------------------------------------------------------
# Ragged-k lane padding (JAX st_interp.py:488-558), on JAX-layout numpy dicts
# ---------------------------------------------------------------------------

def pad_lane_model(spec_real: ModelSpec, k_pad: int, params: Dict[str, Any],
                   consts: Dict[str, Any]
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Pad a real-shape (params, consts) pair to a k_pad-wide spatial basis.

    Invariants that make the padded lane's fit track its own-shape run (up
    to the order of float32 sums):
      - real centers, bandwidths and weight rows occupy the leading rows;
        `spatial_k_mask` in consts zeroes phi's junk columns, so the junk
        rows of the first-layer weights and the junk centers get zero
        gradients;
      - junk centers, log-bandwidths and weight rows start at exactly 0
        (bandwidth 1), so AdamW's decoupled weight decay keeps them at 0
        and no penalty (domain, movement, sparsity) sees them.
    """
    k = spec_real.k_spatial
    pad = k_pad - k
    if pad < 0:
        raise ValueError(f"k_pad {k_pad} < real k {k}")

    def pad0(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])

    new_consts = dict(consts)
    new_consts["spatial_centers_init"] = pad0(consts["spatial_centers_init"])
    new_consts["spatial_bandwidths_init"] = np.concatenate(
        [np.asarray(consts["spatial_bandwidths_init"]),
         np.ones((pad,), np.float32)])
    new_consts["spatial_k_mask"] = (np.arange(k_pad) < k).astype(np.float32)

    new_params = {k2: dict(v) for k2, v in params.items()}
    if "basis" in new_params:
        b = new_params["basis"]
        b["centers"] = pad0(b["centers"])
        b["log_bandwidths"] = pad0(b["log_bandwidths"])
    lin0 = dict(new_params["mlp"]["linear_0"])
    w = np.asarray(lin0["w"])                 # (p + k + k_t, H)
    cut = spec_real.p + k
    lin0["w"] = np.concatenate(
        [w[:cut], np.zeros((pad, w.shape[1]), w.dtype), w[cut:]])
    new_params["mlp"]["linear_0"] = lin0
    return new_params, new_consts


def strip_lane_padding(spec_real: ModelSpec, k_pad: int,
                       params: Dict[str, Any], consts: Dict[str, Any]
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of pad_lane_model: slice the real rows back out, so that
    evaluation and the artifacts carry the lane's real shapes."""
    k = spec_real.k_spatial
    new_consts = dict(consts)
    new_consts["spatial_centers_init"] = np.asarray(
        consts["spatial_centers_init"])[:k]
    new_consts["spatial_bandwidths_init"] = np.asarray(
        consts["spatial_bandwidths_init"])[:k]
    new_consts.pop("spatial_k_mask", None)

    new_params = {k2: dict(v) for k2, v in params.items()}
    if "basis" in new_params:
        b = new_params["basis"]
        b["centers"] = np.asarray(b["centers"])[:k]
        b["log_bandwidths"] = np.asarray(b["log_bandwidths"])[:k]
    lin0 = dict(new_params["mlp"]["linear_0"])
    w = np.asarray(lin0["w"])
    cut = spec_real.p + k
    lin0["w"] = np.concatenate([w[:cut], w[spec_real.p + k_pad:]])
    new_params["mlp"]["linear_0"] = lin0
    return new_params, new_consts
