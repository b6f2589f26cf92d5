"""The lane engine: M fits of one config as one batched program (port of
the uniform-lane path of `st_dadk_tpu/train/batch_engine.py`).

    run_experiment_batch -> run_lane_jobs -> run_job_batch
        _prepare_job_batch   per-lane setups (seed-exact masks, the spatial
                             init through `init_spatial_centers`, the model),
                             lane stacking, per-lane LR tables
        _execute_job_batch   `stack_lane_models` + `loop.fit_lanes`
        _finalize_job_batch  one batched dense predict per dataset
                             (`_batched_eval`), then each lane's results
                             contract through `finalize_experiment`

Lanes may differ in seed, data file, observation design and real batch
count; dataset shapes must match and the configs must share a
`stacking_key`. A job list wider than the lane width runs as consecutive
batches. Every op of a step serves all lanes, so the host's launch cost is
spent once for M fits.

Not carried, each raising NotImplementedError where a caller asks for it:
per-tau jobs (`regression_type: quantile` with several levels), ragged-k
batches (`k_spatial_pad`) and `mesh` arguments. Left out without a knob of
its own: the prepare/finalize threads of `run_job_batches`, tail compaction,
packed transfers, the bf16 flip past a lane count, the streaming pod path
and the on-device metrics program; the knobs that select them stay accepted
and ignored (`config.py`). The spatial init runs lane by lane.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.dataio.arrays import dense_grid_points
from st_dadk_tpu_torch.models.st_interp import (from_jax_params, model_consts,
                                                stack_lane_models)
from st_dadk_tpu_torch.train.experiment import (ExperimentSetup,
                                                finalize_experiment,
                                                metrics_from_preds)
from st_dadk_tpu_torch.train.loop import (FitResult, LaneData, fit_lanes,
                                          predict_lanes, stack_lane_data)
from st_dadk_tpu_torch.train.optimizer import build_lr_tables

Job = Tuple[ExperimentConfig, int, Path]   # (config, experiment id, output dir)

# Lanes a batch on one H100 (80 GB HBM3, 700 W): the width with the least
# wall time a step a lane in the sweep of `profile_fit.py --lanes` on the
# bench workload, 1 to 128 lanes (PERF.md, section 5): the step stayed
# host-bound through 128 lanes, the widest swept, and the same sweep runs a
# batch's dense predict at that width and records its peak memory. Override
# per config with extra['lanes_per_device'].
LANES_PER_DEVICE = 128


def run_experiment_batch(cfg: ExperimentConfig, exp_ids: List[int],
                         experiments_dir: Path, skip_existing: bool = False,
                         verbose: bool = False,
                         device: Optional[torch.device | str] = None,
                         mesh: Any = None) -> List[Dict[str, Any]]:
    """Run all `exp_ids` of one config as lanes of one batched program; one
    results dict a lane that ran. Per-tau jobs (one model a quantile level)
    are not ported."""
    if is_per_tau(cfg):
        raise NotImplementedError(
            "per-tau lanes (regression_type 'quantile' with several levels) "
            "wait for the per-tau fits (ROADMAP Queue 1: the rest of the "
            "fit's options)")
    experiments_dir = Path(experiments_dir)
    jobs = [(cfg, i, experiments_dir / str(i)) for i in exp_ids]
    return run_lane_jobs(jobs, cfg, skip_existing=skip_existing,
                         verbose=verbose, device=device, mesh=mesh)


def is_per_tau(cfg: ExperimentConfig) -> bool:
    """Separate-models-per-tau quantile mode."""
    return (cfg.regression_type == "quantile"
            and len(cfg.quantile_levels) > 1)


_STACKABLE_KEYS = frozenset({
    "data_file", "obs_method", "obs_ratio", "obs_spatial_pattern",
    "obs_spatial_intensity", "split_method", "train_ratio",
    "normalize_target", "tag", "base_seed", "n_experiments", "extra",
    "data_root", "save_artifacts", "device",
})


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def stacking_key(cfg: ExperimentConfig):
    """Configs whose non-observation fields match run the same lane program
    and may share one batch. `cfg.extra` is part of the key: its knobs
    (`shuffle`, `init_subsample`, `init_gmm_n_init`, ...) change the init or
    the epoch program, and the engine reads them from the batch's first
    config."""
    d = dataclasses.asdict(cfg)
    return tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in d.items() if k not in _STACKABLE_KEYS)) + (
            ("extra", _freeze(cfg.extra)),)


def lane_width(cfg: ExperimentConfig) -> int:
    """Lanes a batch: extra['lanes_per_device'] where given, else the
    width measured on the H100."""
    width = int(cfg.extra.get("lanes_per_device", LANES_PER_DEVICE))
    if width < 1:
        raise ValueError(f"lanes_per_device must be >= 1, got {width}")
    return width


def run_lane_jobs(jobs: Sequence[Job], cfg: ExperimentConfig,
                  skip_existing: bool = False, verbose: bool = False,
                  device: Optional[torch.device | str] = None,
                  mesh: Any = None) -> List[Dict[str, Any]]:
    """Run a job list at the lane width: wider lists run as consecutive
    batches of at most `lane_width(cfg)` lanes."""
    width = lane_width(cfg)
    results: List[Dict[str, Any]] = []
    for i in range(0, len(jobs), width):
        results += run_job_batch(jobs[i:i + width],
                                 skip_existing=skip_existing, verbose=verbose,
                                 device=device, mesh=mesh)
    return results


def run_job_batch(jobs: Sequence[Job], skip_existing: bool = False,
                  verbose: bool = False,
                  device: Optional[torch.device | str] = None,
                  mesh: Any = None) -> List[Dict[str, Any]]:
    """Run (config, experiment id, output dir) jobs as lanes of ONE program.
    All configs must share a `stacking_key`; data files and observation
    designs may differ a lane as long as dataset shapes match."""
    if mesh is not None:
        raise NotImplementedError(
            "a mesh of devices needs the parallel package on "
            "torch.distributed (ROADMAP Queue 1 item 7)")
    prep = _prepare_job_batch(jobs, skip_existing=skip_existing,
                              device=device)
    if prep is None:
        return []
    state = _execute_job_batch(prep, verbose=verbose)
    return _finalize_job_batch(state)


def _prepare_job_batch(jobs: Sequence[Job], skip_existing: bool = False,
                       device: Optional[torch.device | str] = None
                       ) -> Optional[Dict[str, Any]]:
    """Per-lane setups (masks, spatial init, model), the stacked lane data
    and the LR tables; None when every job is already on disk."""
    t_start = time.time()
    todo = [(c, i, Path(d)) for c, i, d in jobs
            if not (skip_existing and (Path(d) / "results.json").exists())]
    if not todo:
        return None
    cfg = todo[0][0]
    if len({stacking_key(c) for c, _, _ in todo}) != 1:
        raise ValueError("run_job_batch: configs are not stackable "
                         "(differing model/loop hyperparameters)")
    if cfg.k_spatial_pad is not None:
        raise NotImplementedError(
            "ragged-k lanes (k_spatial_pad) take the materialised-phi "
            "kernels, which have no lane axis yet (ROADMAP Queue 1: config "
            "stacking and ragged-k lanes)")
    if cfg.regression_type not in ("multi-quantile", "mean"):
        raise NotImplementedError(
            f"regression_type {cfg.regression_type!r} is not ported yet")
    if cfg.p_covariates > 0:
        raise NotImplementedError(
            "p_covariates > 0: the fit feeds no covariates")
    dev = torch.device(device or cfg.device)
    setups = []
    for cfg_i, exp_id, out_dir in todo:
        s = ExperimentSetup(cfg_i, exp_id, dev, verbose=False)
        s.out_dir = out_dir
        setups.append(s)
    shapes = {(s.T, s.S) for s in setups}
    if len(shapes) != 1:
        raise ValueError(f"run_job_batch: dataset shapes differ: {shapes}")
    stacked = _stack_lane_host(cfg, setups, dev)
    return dict(cfg=cfg, setups=setups, stacked=stacked, device=dev,
                t_start=t_start, t_prep=time.time() - t_start)


def _lane_lr_tables(cfg: ExperimentConfig, n_batches: Sequence[int],
                    B_shared: int) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Per-lane LR tables: warmup pacing follows the lane's OWN batches per
    epoch (W = warmup_epochs * B_lane). A lane with fewer batches than
    B_shared gets its surplus steps padded with its last real step's LR
    (those steps never execute). Returns (lr_steps (M, epochs, B_shared, 2),
    each lane's recorded LR (epochs,))."""
    cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    tabs, recorded = [], []
    for B_lane in n_batches:
        if B_lane not in cache:
            lm, lb, lrec = build_lr_tables(cfg, B_lane)
            tab = np.stack([lm, lb], -1).reshape(cfg.epochs, B_lane, 2)
            if B_lane < B_shared:
                tab = np.concatenate(
                    [tab, np.repeat(tab[:, -1:], B_shared - B_lane, axis=1)],
                    axis=1)
            cache[B_lane] = (tab, lrec)
        tabs.append(cache[B_lane][0])
        recorded.append(cache[B_lane][1])
    return np.stack(tabs), recorded


def _stack_lane_host(cfg: ExperimentConfig, setups: Sequence[ExperimentSetup],
                     device: torch.device) -> Dict[str, Any]:
    """The lanes' padded buffers stacked on `device` and their LR tables."""
    data = stack_lane_data(cfg, [s.train_ps for s in setups],
                           [s.valid_ps for s in setups], device)
    lr_steps, lr_recorded = _lane_lr_tables(cfg, data.n_batches,
                                            data.B_shared)
    return dict(data=data, lr_steps=lr_steps, lr_recorded=lr_recorded)


def _init_lane_carries(setups: Sequence[ExperimentSetup]):
    """The lanes' initialised models as one `STInterpLanes` (uniform k: the
    lanes share a spec)."""
    return stack_lane_models([s.model for s in setups])


def _execute_job_batch(prep: Dict[str, Any], verbose: bool = False
                       ) -> Dict[str, Any]:
    """The device side of a batch: lane stacking of the models and the
    epoch loop."""
    cfg, setups = prep["cfg"], prep["setups"]
    stacked = prep["stacked"]
    data: LaneData = stacked["data"]
    t0 = time.time()
    lanes_model = _init_lane_carries(setups)
    results = fit_lanes(cfg, setups[0].spec, lanes_model, data,
                        stacked["lr_steps"], stacked["lr_recorded"],
                        [s.experiment_seed for s in setups], verbose=verbose)
    t_train = time.time() - t0
    if verbose:
        print(f"[batch] {len(setups)} experiments x "
              f"{max(r.n_epochs_run for r in results)} epochs in "
              f"{time.time() - prep['t_start']:.1f}s (setup "
              f"{prep['t_prep']:.1f}s, train {t_train:.1f}s)", flush=True)
    return dict(prep, results=results, t_train=t_train, verbose=verbose)


def _eval_group_key(cfg_lane: ExperimentConfig):
    """Lanes are evaluated together only when they share the actual
    dataset and target scaling."""
    return (str(cfg_lane.resolve_data_file()), bool(cfg_lane.normalize_target))


def _batched_eval(cfg: ExperimentConfig, setups: Sequence[ExperimentSetup],
                  results: Sequence[FitResult]) -> List[Dict[str, Any]]:
    """Per-lane split metrics and the dense (T, S) median field from one
    lane-batched predict of the T x S grid per distinct dataset. A chunk of
    `eval_chunk` points holds (lanes, chunk, hidden) activations."""
    groups: Dict[Any, List[int]] = {}
    for li, s in enumerate(setups):
        groups.setdefault(_eval_group_key(s.cfg), []).append(li)
    median_idx = (len(cfg.quantile_levels) // 2
                  if cfg.regression_type == "multi-quantile" else 0)
    out: List[Optional[Dict[str, Any]]] = [None] * len(setups)
    for lanes in groups.values():
        s0 = setups[lanes[0]]
        coords_rep, t_rep = dense_grid_points(s0.T, s0.coords)
        serving = stack_lane_models([
            from_jax_params(setups[li].spec, results[li].params,
                            model_consts(setups[li].model),
                            device=setups[li].device) for li in lanes])
        preds = predict_lanes(serving, coords_rep, t_rep,
                              int(cfg.eval_chunk))
        for gi, li in enumerate(lanes):
            s = setups[li]
            field = preds[gi].reshape(s.T, s.S, -1)
            lane = {"all_predictions": field[:, :, median_idx]}
            for split, mask in (("train_metrics", s.train_mask),
                                ("val_metrics", s.valid_mask),
                                ("test_metrics", s.test_mask)):
                m = mask & np.isfinite(s.z_full)
                lane[split] = metrics_from_preds(s.cfg, field[m],
                                                 s.z_full[m][:, None])
            out[li] = lane
    return out


def _finalize_job_batch(state: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Batched evaluation, then every lane's results contract through
    `finalize_experiment`. A lane's `total_time_seconds` is the batch's wall
    divided by its lanes."""
    cfg, setups, results = state["cfg"], state["setups"], state["results"]
    M = len(setups)
    t_phase = time.time()
    precomputed = _batched_eval(cfg, setups, results)
    t_eval = time.time() - t_phase
    wall = time.time() - state["t_start"]
    out = []
    for li, (s, fit_res) in enumerate(zip(setups, results)):
        s.out_dir.mkdir(parents=True, exist_ok=True)
        r = finalize_experiment(
            s.cfg, s, fit_res, s.out_dir, wall / M, verbose=False,
            stage_timings={"setup_seconds": state["t_prep"] / M, **s.timings,
                           "train_seconds": state["t_train"] / M,
                           "batch_lanes": M,
                           "batch_setup_seconds": state["t_prep"],
                           "batch_train_seconds": state["t_train"],
                           "batch_eval_seconds": t_eval,
                           **fit_res.timings},
            precomputed=precomputed[li],
            steps_per_epoch=state["stacked"]["data"].B_shared)
        out.append(r)
    if state["verbose"]:
        print(f"[batch] finalize (eval + artifacts) "
              f"{time.time() - t_phase:.1f}s", flush=True)
    return out
