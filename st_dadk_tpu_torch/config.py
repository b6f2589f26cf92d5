"""Typed experiment configuration (copy of `st_dadk_tpu/config.py`).

Every known key is a dataclass field with the reference code's default;
unknown keys are kept in `extra`. The fields are the JAX package's that
the port reads; the others (TPU knobs, CLI and plotting keys) land in
`extra`, so a config file of the JAX package loads here and round-trips.
`yaml` is imported only by the YAML reader and writer.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class ExperimentConfig:
    # -- experiment identity --------------------------------------------------
    tag: str = "default"
    data_file: str = "data/2b/2b_7.csv"
    base_seed: int = 42
    n_experiments: int = 10       # repeats of the runner (seeds base_seed + i - 1)
    device: str = "cuda"          # the port's default torch device

    # -- model architecture ---------------------------------------------------
    k_spatial_centers: List[int] = field(default_factory=lambda: [25, 81, 121])
    k_temporal_centers: List[int] = field(default_factory=lambda: [10, 15, 45])
    spatial_basis_function: str = "wendland"   # wendland | gaussian | triangular
    spatial_init_method: str = "uniform"       # uniform | gmm (others: not ported)
    spatial_learnable: bool = False
    hidden_dims: List[int] = field(default_factory=lambda: [256, 256, 128])
    dropout: float = 0.1
    layernorm: bool = True
    p_covariates: int = 0
    use_delta_reparameterization: bool = False

    # -- learnable-basis control ----------------------------------------------
    gradient_damping: bool = False
    damping_threshold: float = 0.3
    damping_strength: float = 1.0
    domain_penalty_weight: float = 0.0
    movement_penalty_weight: float = 0.0
    basis_lr_ratio: float = 0.05
    basis_unfreeze_epoch: int = 0
    basis_lr_rampup_epochs: int = 0

    # -- sparsity penalty ------------------------------------------------------
    sparsity_penalty_type: str = "none"        # none | element | group | sparse_group
    sparsity_lambda_l1: float = 0.001
    sparsity_lambda_group: float = 0.01
    sparsity_apply_to_spatial: bool = True
    sparsity_apply_to_temporal: bool = True

    # -- non-crossing penalty (multi-quantile) ---------------------------------
    non_crossing_weight: float = 0.0
    non_crossing_power: int = 1
    non_crossing_lambda: float = 0.0
    non_crossing_delta_mode: str = "eq310"

    # -- observation design ----------------------------------------------------
    obs_method: str = "site-wise"              # site-wise | random
    obs_ratio: float = 0.5
    obs_spatial_pattern: str = "uniform"       # uniform | corner
    obs_spatial_intensity: float = 1.0
    split_method: str = "site-wise"            # site-wise | random
    train_ratio: float = 0.8
    normalize_target: bool = False

    # -- training ----------------------------------------------------------------
    epochs: int = 100
    lr: float = 1e-3
    weight_decay: float = 1e-5
    batch_size: int = 256
    patience: int = 15
    early_stop_min_rel_delta: float = 0.0
    grad_clip: float = 0.0
    scheduler: Optional[str] = None            # None | 'cosine'
    warmup_epochs: int = 0

    # -- regression head ---------------------------------------------------------
    regression_type: str = "mean"              # mean | multi-quantile
    quantile_levels: List[float] = field(default_factory=lambda: [0.1, 0.5, 0.9])

    # -- kernel routes (the JAX package's opt-ins; see models/st_interp.py) -----
    use_pallas_training: bool = False          # phi built on its own in training
    use_fused_training: bool = False           # fused basis->layer-1 in training

    # -- port extras -------------------------------------------------------------
    data_root: Optional[str] = None            # prefix for relative data_file paths
    train_dtype: str = "auto"                  # the port trains in float32 only
    k_spatial_pad: Optional[int] = None        # ragged-k lane: phi padded to this width
    save_artifacts: bool = True                # model/prediction/basis npz files
    eval_chunk: int = 32768                    # points per predict chunk

    # unknown keys. The port reads 'shuffle' ('none' = identity order),
    # 'init_subsample', 'init_gmm_n_init' and 'lanes_per_device' (lanes a
    # batch of the lane engine);
    # `unported_fit_knobs` names the JAX fit knobs it refuses, and the setup
    # raises on them. Accepted and ignored on purpose: the JAX package's TPU
    # and lane-engine knobs, which change how a fit runs there but not its
    # numbers ('pregather', 'remat', 'profile_dir', 'packed_upload',
    # 'final_stop_sync', 'packed_finalize_pull',
    # 'pipeline_blocking_finalize': a loop of `run_job_batch` is the port's
    # serial baseline; the JAX-only fields
    # 'packed_optimizer',
    # 'scan_unroll', 'tail_compaction', 'compaction_epoch', 'mesh_axis',
    # 'dropout_rng' (its RNG streams do not cross frameworks anyway) and the
    # CLI and plotting keys), and 'init_gmm_fused': JAX runs the resolutions'
    # GMM EMs as one loop with the same seeding keys and the same tol stop
    # for each (resolution, restart) (st_dadk_tpu/ops/init_centers.py:
    # 408-434 against :281-303), the EM the port runs per resolution; on
    # the CPU the two JAX programs give bitwise equal centers and sigmas.
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        known = {f.name for f in dataclasses.fields(cls) if f.name != "extra"}
        kwargs: Dict[str, Any] = {}
        extra: Dict[str, Any] = {}
        for k, v in d.items():
            if k in known:
                kwargs[k] = v
            else:
                extra[k] = v
        cfg = cls(**kwargs)
        cfg.extra = extra
        # YAML often stores scientific-notation floats as strings
        cfg.lr = float(cfg.lr)
        cfg.weight_decay = float(cfg.weight_decay)
        return cfg

    @classmethod
    def from_yaml(cls, path: str | Path) -> "ExperimentConfig":
        import yaml
        with open(path, "r", encoding="utf-8") as f:
            d = yaml.safe_load(f) or {}
        return cls.from_dict(d)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        extra = d.pop("extra")
        d.update(extra)
        return d

    def to_yaml(self, path: str | Path) -> None:
        import yaml
        with open(path, "w", encoding="utf-8") as f:
            yaml.dump(self.to_dict(), f, default_flow_style=False)

    def replace(self, **kwargs: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)

    def resolve_data_file(self) -> Path:
        """Resolve the data file against data_root, the CWD and the
        checkout's root."""
        p = Path(self.data_file)
        if p.is_absolute():
            return p
        roots = []
        if self.data_root:
            roots.append(Path(self.data_root))
        roots += [Path.cwd(), Path(__file__).resolve().parent.parent]
        for root in roots:
            cand = root / p
            if cand.exists():
                return cand
        return p

    @property
    def output_dim(self) -> int:
        if self.regression_type == "multi-quantile":
            return len(self.quantile_levels)
        return 1

    def json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def unported_fit_knobs(cfg: ExperimentConfig) -> List[str]:
    """The JAX fit knobs in `cfg.extra` that change a fit's numbers and that
    the port does not carry (st_dadk_tpu/train/experiment.py:304-308,
    train/loop.py:196):
      - 'init_seed_rounds': R-round k-means++ seeding in place of the exact
        sequential draw (st_dadk_tpu/ops/init_centers.py:170-177);
      - 'init_em_dtype: bfloat16': the GMM EM's (n, k) tensors stored in
        bf16 (any other value keeps float32, init_centers.py:230);
      - 'ablate_validate: true': the train loss stands in for the
        validation loss (loop.py:550-551)."""
    extra = cfg.extra
    knobs = []
    if extra.get("init_seed_rounds") is not None:
        knobs.append("init_seed_rounds")
    if extra.get("init_em_dtype") == "bfloat16":
        knobs.append("init_em_dtype")
    if bool(extra.get("ablate_validate", False)):
        knobs.append("ablate_validate")
    return knobs
