"""Direct multi-horizon forecaster over sliding windows (port of
`st_dadk_tpu/models/forecaster.py`).

Per (window, site) sample the features are

    [ y_hist (L) | phi(s) spatial basis (k_s) | psi(t0) temporal basis ]
    -> (Linear -> LayerNorm -> ReLU -> Dropout)* -> Linear -> (H,)

phi is built with fixed uniform-grid centers through the materialised-phi
kernel (`ops/spatial_basis_kernels.py`): on the card every forward launches
the phi forward kernel, and since neither the centers nor the coords need a
gradient, no basis backward kernel ever runs. JAX builds that phi with the
jnp embed, which XLA fuses; eager PyTorch has no such fusion, so the hand
kernel is its counterpart.

`fit_forecaster` is JAX's minibatch AdamW with validation-based early
stopping: JAX scans over all epochs and freezes the carry once stopped,
this loop breaks at the stop, and the history is the same (NaN after the
stop). Weights keep the JAX layout (`linear_i.{w,b}` with w (in, out),
`ln_i.{scale,bias}`, `out.{w,b}`); `forecaster_params_from_jax` carries a
JAX `init_forecaster` tree across.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from st_dadk_tpu_torch.ops.basis import (temporal_basis_embed,
                                         temporal_grid_centers,
                                         uniform_grid_centers)
from st_dadk_tpu_torch.ops.spatial_basis_kernels import \
    spatial_basis_embed_kernel
from st_dadk_tpu_torch.train.optimizer import AdamW

_CONSTS = ("spatial_centers", "spatial_bandwidths", "temporal_centers",
           "temporal_bandwidths")


@dataclass(frozen=True)
class ForecastSpec:
    L: int = 20
    H: int = 10
    k_spatial_centers: Tuple[int, ...] = (25, 81)
    k_temporal_centers: Tuple[int, ...] = (10, 15)
    hidden_dims: Tuple[int, ...] = (256, 128)
    dropout: float = 0.1
    spatial_basis_function: str = "wendland"

    @property
    def k_spatial(self) -> int:
        return int(sum(self.k_spatial_centers))

    @property
    def k_temporal(self) -> int:
        return int(sum(self.k_temporal_centers))

    @property
    def input_dim(self) -> int:
        return self.L + self.k_spatial + self.k_temporal


class _Linear(nn.Module):
    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(fan_in, fan_out))
        self.b = nn.Parameter(torch.empty(fan_out))


class _LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class Forecaster(nn.Module):
    """The forecaster network of one `ForecastSpec`. Parameters:
    `linear_i.{w,b}`, `ln_i.{scale,bias}`, `out.{w,b}`; buffers: the fixed
    spatial and temporal grids."""

    def __init__(self, spec: ForecastSpec):
        super().__init__()
        self.spec = spec
        sc, sb = uniform_grid_centers(spec.k_spatial_centers)
        tc, tb = temporal_grid_centers(spec.k_temporal_centers)
        for name, arr in zip(_CONSTS, (sc, sb, tc, tb)):
            self.register_buffer(name, torch.as_tensor(arr))
        prev = spec.input_dim
        for i, h in enumerate(spec.hidden_dims):
            setattr(self, f"linear_{i}", _Linear(prev, h))
            setattr(self, f"ln_{i}", _LayerNorm(h))
            prev = h
        self.out = _Linear(prev, spec.H)

    def forward(self, y_hist: torch.Tensor, coords: torch.Tensor,
                t0: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """y_hist (B, L), coords (B, 2), t0 (B, 1) normalised -> (B, H).
        Dropout (train=True, dropout > 0) draws one (B, h) uniform block a
        hidden layer from `generator`."""
        spec = self.spec
        phi = spatial_basis_embed_kernel(coords, self.spatial_centers,
                                         self.spatial_bandwidths,
                                         spec.spatial_basis_function)
        psi = temporal_basis_embed(t0, self.temporal_centers,
                                   self.temporal_bandwidths)
        h = torch.cat([y_hist, phi, psi], dim=-1)
        use_dropout = train and spec.dropout > 0.0
        if use_dropout and generator is None:
            raise ValueError("generator required for dropout in train mode")
        for i, hdim in enumerate(spec.hidden_dims):
            lin, ln = getattr(self, f"linear_{i}"), getattr(self, f"ln_{i}")
            h = torch.nn.functional.layer_norm(h @ lin.w + lin.b, (hdim,),
                                               ln.scale, ln.bias, eps=1e-5)
            h = torch.relu(h)
            if use_dropout:
                keep = torch.rand(h.shape, generator=generator,
                                  device=h.device) < (1.0 - spec.dropout)
                h = torch.where(keep, h / (1.0 - spec.dropout),
                                torch.zeros((), dtype=h.dtype,
                                            device=h.device))
        return h @ self.out.w + self.out.b


def init_forecaster(generator: torch.Generator, spec: ForecastSpec,
                    device: torch.device | str = "cuda") -> Forecaster:
    """A forecaster initialised like JAX's `init_forecaster` (Linear
    U(+-1/sqrt(fan_in)), LayerNorm 1/0), drawn from a CPU `generator`, on
    `device` (the card unless the caller names the CPU)."""
    model = Forecaster(spec)
    with torch.no_grad():
        lins = [getattr(model, f"linear_{i}")
                for i in range(len(spec.hidden_dims))] + [model.out]
        for lin in lins:
            bound = 1.0 / float(np.sqrt(lin.w.shape[0]))
            lin.w.copy_((torch.rand(lin.w.shape, generator=generator) * 2 - 1)
                        * bound)
            lin.b.copy_((torch.rand(lin.b.shape, generator=generator) * 2 - 1)
                        * bound)
    return model.to(device)


def forecaster_params_from_jax(params: Dict[str, Any],
                               consts: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """A JAX (params, consts) pair of `init_forecaster` (numpy or JAX
    arrays) as the port's `Forecaster` state dict (CPU float32 tensors)."""
    state = {f"{layer}.{leaf}": torch.tensor(np.asarray(v, np.float32))
             for layer, leaves in params.items() for leaf, v in leaves.items()}
    for name in _CONSTS:
        state[name] = torch.tensor(np.asarray(consts[name], np.float32))
    return state


def forecaster_from_jax(spec: ForecastSpec, params: Dict[str, Any],
                        consts: Dict[str, Any],
                        device: torch.device | str = "cuda") -> Forecaster:
    """A `Forecaster` holding a JAX (params, consts) pair, on `device`."""
    model = Forecaster(spec)
    model.load_state_dict(forecaster_params_from_jax(params, consts))
    return model.to(device)


def forecaster_params(model: Forecaster) -> Dict[str, Dict[str, np.ndarray]]:
    """The model's parameters as the nested numpy dict of the JAX layout."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for name, p in model.named_parameters():
        layer, leaf = name.split(".")
        tree.setdefault(layer, {})[leaf] = p.detach().cpu().numpy().copy()
    return tree


class ForecastData(NamedTuple):
    y_hist: np.ndarray    # (n, L)
    coords: np.ndarray    # (n, 2)
    t0: np.ndarray        # (n, 1)
    y_fut: np.ndarray     # (n, H)


def rows_from_windows(ds, T_total: int) -> ForecastData:
    """Flatten a WindowDataset (W windows x n_obs sites) into per-sample
    rows for the pointwise forecaster (JAX forecaster.py:124-137)."""
    W, L, n_obs, _ = ds.y_hist.shape
    H = ds.y_fut.shape[1]
    y_hist = np.transpose(ds.y_hist[..., 0], (0, 2, 1)).reshape(-1, L)
    y_fut = np.transpose(ds.y_fut[..., 0], (0, 2, 1)).reshape(-1, H)
    coords = np.broadcast_to(ds.obs_coords[None], (W, n_obs, 2)).reshape(-1, 2)
    t0 = np.repeat(ds.t0.astype(np.float32) / max(T_total - 1, 1), n_obs)
    return ForecastData(y_hist=y_hist.astype(np.float32), coords=coords,
                        t0=t0[:, None], y_fut=y_fut.astype(np.float32))


def _on(rows: ForecastData, device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                 device=device) for x in rows)


@torch.no_grad()
def predict_forecaster(model: Forecaster, y_hist: np.ndarray,
                       coords: np.ndarray, t0: np.ndarray,
                       chunk: int = 32768) -> np.ndarray:
    """Eval-mode forecasts (n, H) as numpy, `chunk` rows a forward."""
    device = next(model.parameters()).device
    outs = []
    for s in range(0, y_hist.shape[0], chunk):
        yh, c, t = (torch.as_tensor(np.ascontiguousarray(a[s:s + chunk],
                                                         np.float32),
                                    device=device)
                    for a in (y_hist, coords, t0))
        outs.append(model(yh, c, t.reshape(-1, 1)))
    return torch.cat(outs).cpu().numpy()


def fit_forecaster(model: Forecaster, train_rows: ForecastData,
                   valid_rows: ForecastData, epochs: int = 200,
                   batch_size: int = 1024, lr: float = 1e-3,
                   weight_decay: float = 1e-5, patience: int = 20,
                   generator: Optional[torch.Generator] = None,
                   seed: int = 0, verbose: bool = False
                   ) -> Tuple[Dict[str, Dict[str, np.ndarray]], Dict[str, Any]]:
    """AdamW at a flat `lr` with early stopping on the validation MSE (JAX
    forecaster.py:140-226), on the model's device; the model ends holding
    the best parameters. The training rows are tiled up to cap = ceil(n /
    bs) * bs, every epoch draws a fresh permutation of them, and the
    permutations and the dropout draw from `generator` (default: one on the
    model's device seeded with `seed`). Returns (best params in the JAX
    layout, {"val_mse" (epochs,) NaN after the stop, "best_val",
    "n_epochs_run"})."""
    device = next(model.parameters()).device
    gen = (generator if generator is not None
           else torch.Generator(device=device).manual_seed(int(seed)))
    n = train_rows.y_hist.shape[0]
    bs = min(batch_size, n)
    B = max(1, -(-n // bs))
    cap = B * bs

    def pad(a: np.ndarray) -> np.ndarray:
        reps = -(-cap // a.shape[0])
        return np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:cap]

    data = _on(ForecastData(*(pad(np.asarray(x)) for x in train_rows)),
               device)
    va_yh, va_c, va_t, va_y = _on(valid_rows, device)
    params = list(model.parameters())
    opt = AdamW({"mlp": params}, weight_decay)
    best = copy.deepcopy(model.state_dict())
    best_val, pat = float("inf"), 0
    vls = np.full(int(epochs), np.nan)
    for epoch in range(int(epochs)):
        idx = torch.randperm(cap, generator=gen, device=device).reshape(B, bs)
        for b in range(B):
            i = idx[b]
            for p in params:
                p.grad = None
            pred = model(data[0][i], data[1][i], data[2][i], train=True,
                         generator=gen)
            torch.mean((pred - data[3][i]) ** 2).backward()
            opt.step({"mlp": lr})
        with torch.no_grad():
            vl = float(torch.mean((model(va_yh, va_c, va_t) - va_y) ** 2))
        vls[epoch] = vl
        if vl < best_val:
            best_val, pat = vl, 0
            best = copy.deepcopy(model.state_dict())
        else:
            pat += 1
        if pat >= patience:
            break
    model.load_state_dict(best)
    hist = {"val_mse": vls, "best_val": best_val,
            "n_epochs_run": int(np.sum(~np.isnan(vls)))}
    if verbose:
        print(f"[forecast] best val MSE {hist['best_val']:.5f} "
              f"({hist['n_epochs_run']} epochs)")
    return forecaster_params(model), hist
