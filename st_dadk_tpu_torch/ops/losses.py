"""Losses, penalties and probabilistic scores (port of
`st_dadk_tpu/ops/losses.py`).

The on-device losses take an optional weight vector, so padded batches
reproduce the reference's ragged-batch means: weighted_mean(x, w) ==
mean(x[w > 0]) for 0/1 weights. The numpy scores run on eval results.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _weighted_mean(x: torch.Tensor, weights: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    if weights is None:
        return torch.mean(x)
    w = weights.reshape(x.shape[0], *([1] * (x.dim() - 1)))
    denom = torch.clamp(torch.sum(w) * (x.numel() / x.shape[0]), min=1e-12)
    return torch.sum(x * w) / denom


def quantile_loss(y_pred: torch.Tensor, y_true: torch.Tensor, quantile,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Check loss rho_tau, mean over the (optionally weighted) batch."""
    errors = y_true - y_pred
    per_elem = torch.maximum((quantile - 1.0) * errors, quantile * errors)
    return _weighted_mean(per_elem, weights)


def multi_quantile_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
                        quantile_levels: torch.Tensor,
                        weights: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Mean over quantiles of the check loss: y_pred (B, Q), y_true (B, 1),
    quantile_levels (Q,)."""
    errors = y_true - y_pred
    q = quantile_levels[None, :]
    per_elem = torch.maximum((q - 1.0) * errors, q * errors)
    if weights is None:
        return torch.mean(per_elem)
    w = weights[:, None]
    denom = torch.clamp(torch.sum(w), min=1e-12)
    return torch.sum(per_elem * w) / (denom * per_elem.shape[1])


def mse_loss(y_pred: torch.Tensor, y_true: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _weighted_mean((y_pred - y_true) ** 2, weights)


def non_crossing_penalty(y_pred_multi_q: torch.Tensor, reduction: str = "mean",
                         power: int = 1,
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Prediction-level hinge penalty on quantile crossings."""
    if y_pred_multi_q.dim() != 2 or y_pred_multi_q.shape[1] < 2:
        return y_pred_multi_q.new_zeros(())
    violations = torch.relu(y_pred_multi_q[:, :-1] - y_pred_multi_q[:, 1:])
    if power == 2:
        violations = violations ** 2
    elif power != 1:
        raise ValueError(f"Unsupported power={power}; use 1 or 2.")
    per_sample = violations.sum(dim=1)
    if reduction == "mean":
        return _weighted_mean(per_sample, weights)
    if reduction == "sum":
        if weights is not None:
            per_sample = per_sample * weights
        return per_sample.sum()
    raise ValueError(f"Unsupported reduction='{reduction}'; use 'mean' or 'sum'.")


def p_nc_delta_penalty(delta: Optional[torch.Tensor]) -> torch.Tensor:
    """P_nc(delta) on the stacked delta matrix (Q, d+1) (Eq. 3.10), <= 0;
    added to the loss as-is, like the reference."""
    if delta is None or delta.shape[0] < 2:
        return torch.zeros(())
    d = delta[1:]
    d0 = d[:, 0]
    sum_negative = torch.relu(-d[:, 1:]).sum(dim=1)
    return (d0 - torch.maximum(d0, sum_negative)).sum()


# ---------------------------------------------------------------------------
# Lane forms: M independent fits, one loss a lane. y_pred (M, B, Q or 1),
# y_true (M, B, 1), weights (M, B); each returns (M,), lane i equal to the
# single form on lane i's slices up to the order of the sums.
# ---------------------------------------------------------------------------

def _lane_weighted_mean(x: torch.Tensor, weights: torch.Tensor
                        ) -> torch.Tensor:
    w = weights.reshape(*weights.shape, *([1] * (x.dim() - 2)))
    per_point = x[0, 0].numel()
    denom = torch.clamp(torch.sum(weights, dim=1) * per_point, min=1e-12)
    return torch.sum(x * w, dim=tuple(range(1, x.dim()))) / denom


def quantile_loss_lanes(y_pred: torch.Tensor, y_true: torch.Tensor,
                        quantile, weights: torch.Tensor) -> torch.Tensor:
    """`quantile_loss` a lane: y_pred and y_true (M, B, 1); `quantile` one
    tau for all lanes (a float) or a lane's own tau, a tensor (M,)."""
    errors = y_true - y_pred
    if isinstance(quantile, torch.Tensor):
        quantile = quantile.reshape(-1, *([1] * (errors.dim() - 1)))
    per_elem = torch.maximum((quantile - 1.0) * errors, quantile * errors)
    return _lane_weighted_mean(per_elem, weights)


def multi_quantile_loss_lanes(y_pred: torch.Tensor, y_true: torch.Tensor,
                              quantile_levels: torch.Tensor,
                              weights: torch.Tensor) -> torch.Tensor:
    errors = y_true - y_pred
    q = quantile_levels[None, None, :]
    per_elem = torch.maximum((q - 1.0) * errors, q * errors)
    denom = torch.clamp(torch.sum(weights, dim=1), min=1e-12)
    return (torch.sum(per_elem * weights[..., None], dim=(1, 2))
            / (denom * per_elem.shape[2]))


def mse_loss_lanes(y_pred: torch.Tensor, y_true: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    return _lane_weighted_mean((y_pred - y_true) ** 2, weights)


def non_crossing_penalty_lanes(y_pred_multi_q: torch.Tensor, power: int,
                               weights: torch.Tensor) -> torch.Tensor:
    """Mean-reduced prediction-level hinge penalty on quantile crossings."""
    if y_pred_multi_q.shape[-1] < 2:
        return y_pred_multi_q.new_zeros((y_pred_multi_q.shape[0],))
    violations = torch.relu(y_pred_multi_q[..., :-1] - y_pred_multi_q[..., 1:])
    if power == 2:
        violations = violations ** 2
    elif power != 1:
        raise ValueError(f"Unsupported power={power}; use 1 or 2.")
    return _lane_weighted_mean(violations.sum(dim=-1), weights)


def p_nc_delta_penalty_lanes(delta: torch.Tensor) -> torch.Tensor:
    """P_nc(delta) of each lane's stacked delta matrix: (M, Q, d+1) -> (M,)."""
    if delta.shape[1] < 2:
        return delta.new_zeros((delta.shape[0],))
    d = delta[:, 1:]
    d0 = d[..., 0]
    sum_negative = torch.relu(-d[..., 1:]).sum(dim=-1)
    return (d0 - torch.maximum(d0, sum_negative)).sum(dim=-1)


# ---------------------------------------------------------------------------
# Offline (numpy) scores
# ---------------------------------------------------------------------------

def check_loss_np(y_pred: np.ndarray, y_true: np.ndarray,
                  quantile: float) -> float:
    errors = (np.asarray(y_true, dtype=np.float64)
              - np.asarray(y_pred, dtype=np.float64))
    return float(np.mean(np.maximum((quantile - 1.0) * errors,
                                    quantile * errors)))


def compute_crps(predictions_dict: Dict[float, np.ndarray], y_true: np.ndarray,
                 weights: Optional[Sequence[float]] = None) -> float:
    """CRPS by quantile quadrature (Eq. 4.6): 2 * sum_k w_k rho_tau_k, with
    uniform weights by default and custom weights normalised."""
    quantiles = sorted(predictions_dict.keys())
    K = len(quantiles)
    if K == 0:
        raise ValueError("predictions_dict cannot be empty")
    if K == 1:
        q = quantiles[0]
        return 2.0 * check_loss_np(predictions_dict[q], y_true, q)
    if weights is None:
        w = np.full(K, 1.0 / K)
    else:
        w = np.asarray(weights, dtype=np.float64)
        if len(w) != K:
            raise ValueError(f"weights length ({len(w)}) must match number "
                             f"of quantiles ({K})")
        w = w / w.sum()
    crps_sum = 0.0
    for i, q in enumerate(quantiles):
        crps_sum += w[i] * check_loss_np(predictions_dict[q], y_true, q)
    return 2.0 * float(crps_sum)


def compute_crps_multi_quantile(preds: np.ndarray, y_true: np.ndarray,
                                quantile_levels: Sequence[float],
                                weights: Optional[Sequence[float]] = None
                                ) -> float:
    """CRPS from an (N, Q) prediction matrix."""
    y = np.asarray(y_true)
    if y.ndim > 1:
        y = y.reshape(-1)
    predictions_dict = {q: preds[:, i] for i, q in enumerate(quantile_levels)}
    return compute_crps(predictions_dict, y, weights=weights)
