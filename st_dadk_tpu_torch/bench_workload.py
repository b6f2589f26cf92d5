"""The bench workload: one full DA-STDK fit (copy of
`st_dadk_tpu/bench_workload.py`).

Dataset 2a_8 (T=100, S=1000), multi-quantile tau={.05,.25,.5,.75,.95},
GMM-initialised learnable Wendland basis (25/81/121 centers), 70 temporal
centers, MLP 256-256-128 with LayerNorm, ReLU and dropout 0.1, AdamW 2e-2
with warmup/cosine and EMA, 500 epochs max with patience 50.
"""
from __future__ import annotations

from typing import Any, Dict

BENCH_WORKLOAD: Dict[str, Any] = dict(
    tag="bench",
    data_file="data/2a/2a_8.csv",
    k_spatial_centers=[25, 81, 121],
    k_temporal_centers=[10, 15, 45],
    spatial_basis_function="wendland",
    spatial_init_method="gmm",
    spatial_learnable=True,
    gradient_damping=True, damping_threshold=0.0, damping_strength=5.0,
    domain_penalty_weight=0.01,
    sparsity_penalty_type="sparse_group",
    sparsity_lambda_l1=0.0, sparsity_lambda_group=0.0,
    sparsity_apply_to_temporal=False,
    hidden_dims=[256, 256, 128], dropout=0.1, layernorm=True,
    obs_method="site-wise", obs_ratio=0.1,
    obs_spatial_pattern="corner", obs_spatial_intensity=10.0,
    split_method="random", train_ratio=0.8,
    epochs=500, lr=2e-2, basis_lr_ratio=0.05, weight_decay=5e-4,
    batch_size=4096, patience=50, grad_clip=10.0,
    scheduler="cosine", warmup_epochs=10,
    basis_unfreeze_epoch=10, basis_lr_rampup_epochs=10,
    regression_type="multi-quantile",
    quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
    base_seed=2025,
    save_plots=False, save_artifacts=False,
)


def bench_workload(**overrides: Any) -> Dict[str, Any]:
    """A fresh copy of the bench workload with explicit overrides applied."""
    return {**{k: (list(v) if isinstance(v, list) else v)
               for k, v in BENCH_WORKLOAD.items()}, **overrides}
