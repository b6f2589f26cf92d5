"""The lane engine: M fits as one batched program (port of
`st_dadk_tpu/train/batch_engine.py`: uniform lanes, config stacking with
ragged-k lanes, and the threaded batch pipeline).

    run_experiment_batch -> run_lane_jobs -> run_job_batch | run_job_batches
        _prepare_job_batch   host only: per-lane setups (seed-exact masks,
                             point sets, no model yet), lane stacking on the
                             CPU, per-lane LR tables
        _execute_job_batch   the upload, `_init_lane_carries` (the spatial
                             init of all lanes at once through
                             `init_spatial_centers_batch`, each lane's model
                             at its real shapes, padded and stacked) and
                             `loop.fit_lanes`
        _finalize_job_batch  the batch's metrics: on the device
                             (`_batched_eval_device`) where no lane needs
                             the dense field and one process runs, else one
                             batched dense predict per dataset on pulled
                             params (`_batched_eval`); then each lane's
                             results contract through `finalize_experiment`

Lanes may differ in seed, data file, observation design and real batch
count; dataset shapes must match and the configs must share a
`stacking_key`. With `k_spatial_pad` set, `k_spatial_centers` leaves the key:
configs that differ only in their real resolutions run as ragged-k lanes of
one program, padded to the shared width, each lane's junk rows held at
exactly 0 by its column mask inside the spatial-basis kernels; a lane is
written (params, basis info, `model_parameters`) at its real shapes. Every
op of a step serves all lanes, so the host's launch cost is spent once for
M fits.

A job list wider than the lane width runs through `run_job_batches`: while
batch k trains on the main thread, a prepare thread does batch k+1's host
work and a finalize thread evaluates and writes batch k-1. All device work
of the init and the fit stays on the main thread; the finalize thread's
dense predict enqueues on the same default stream, which is safe and serial.
Masks and subsamples draw from each setup's private `RandomState`
(`train/experiment.py`), so the threads need no lock where the JAX package
holds `GLOBAL_NP_RNG_LOCK`. The JAX engine pads a tail batch to the common
lane width to reuse its compiled program; eager PyTorch compiles nothing, so
a tail batch runs at its own width.

Per-tau quantile fits (`regression_type: quantile` with several levels)
run as one lane a (experiment, tau), written to `<i>/quantile_<q>/` as the
single path writes them; a batch of one tau trains on it as a float, a
batch of several taus takes each lane's tau as lane data; then each
experiment's aggregated `results.json` comes from the single path's reload
(`aggregate_per_tau`).

`train_dtype: auto` resolves a batch's trunk dtype by its lane width as
well as by the model's size (`_apply_auto_train_dtype`, JAX :389-414, at
`AUTO_BF16_LANES`); `tail_compaction` narrows a batch to its active lanes
once (`loop.fit_lanes`, JAX :906-1030).

Lanes across processes (JAX :229-234, :493-505, :573-680, :884-891): with
a process group joined, or a `mesh` (`parallel/mesh.py`) given, each
process takes its `process_lane_slice` of the batch's lane axis (padded to a
multiple of the mesh's lane axis, in the job list's own order, before any
`skip_existing` filter, so every process computes the same split), sets up
and trains only those lanes on its own device, and writes only their
artifacts; a pad row is no lane, since no program is shared across
processes. The stream of batches runs serially (no pipeline threads), as in
JAX. The caller (the runner, the grid) aggregates on the primary after a
barrier. A lane's dropout masks come from its batch's generator
(`loop.fit_lanes`), so a lane held by another process draws other masks
than in a single-process batch; at dropout 0 with `shuffle: none` it is the
same lane.

Lanes nested over an 'exp' x 'data' mesh (JAX `jitted_fit_chunk(spec_dp,
vmapped=True, mesh=..., spmd_axis='exp')`, loop.py:883-902): the layout is
JAX's, lanes split over 'exp' and replicated over 'data'. The ranks of a
data row own the same lanes (`owned_lane_slice`), and each lane's minibatch
rows split over the row (`loop.fit_lanes(dp=DPGroup.from_mesh(mesh, device,
'data'))`), as JAX's loop splits them with `dp_axis='data'`: one all_reduce
a step of the lane-stacked gradients and losses. The row's rank 0 alone
finalizes and writes its lanes.

The metrics of a batch (JAX :1516-1582): where no lane writes or reads the
dense field (no `save_artifacts`, no `save_plots`, no per-tau lane) and one
process runs, the serving params stay on the device after the fit
(`fit_lanes(serving_out=...)`) and `_batched_eval_device` scores every lane
there; only (M, 3, K) scalars reach the host. The params are pulled only
for a ragged batch's stripped writes, a lane with a non-finite history (its
NaN diagnostics) or the per-lane fallback when the device metrics raise
(counted in `eval_fallbacks`). Left out without a knob of its own: packed transfers and the
streaming pod path (their knobs stay accepted and ignored, `config.py`):
host-device copies are a small share of a batch on the card (PERF.md,
section 5, `trace_steady_state.py`).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from st_dadk_tpu_torch.config import ExperimentConfig, resolve_device
from st_dadk_tpu_torch.dataio.arrays import dense_grid_points
from st_dadk_tpu_torch.models.st_interp import (STInterpLanes,
                                                from_jax_params, model_consts,
                                                select_lanes,
                                                stack_lane_models)
from st_dadk_tpu_torch.ops.init_centers import (DATA_ADAPTIVE_INIT_METHODS,
                                                init_spatial_centers_batch)
from st_dadk_tpu_torch.parallel.data_parallel import DPGroup
from st_dadk_tpu_torch.parallel.multihost import (experiment_mesh_auto,
                                                  is_primary, local_device,
                                                  process_info,
                                                  process_lane_slice,
                                                  sync_processes)
from st_dadk_tpu_torch.train.experiment import (ExperimentSetup,
                                                finalize_experiment,
                                                init_knobs,
                                                metrics_from_preds,
                                                run_single_experiment)
from st_dadk_tpu_torch.train.loop import (FitResult, LaneData, fit_lanes,
                                          lane_data_to, predict_lanes,
                                          pull_lane_params, stack_lane_data)
from st_dadk_tpu_torch.train.optimizer import build_lr_tables

Job = Tuple[ExperimentConfig, int, Path]   # (config, experiment id, output dir)

# the mesh axis a lane's minibatch splits over (lanes nested over exp x data)
DATA_AXIS = "data"

# Lanes a batch on one H100 (80 GB HBM3, 700 W): the width with the least
# wall time a step a lane in the sweep of `profile_fit.py --lanes` on the
# bench workload, 1 to 128 lanes (PERF.md, section 5): the step stayed
# host-bound through 128 lanes, the widest swept, and the same sweep runs a
# batch's dense predict at that width and records its peak memory. Override
# per config with extra['lanes_per_device'].
LANES_PER_DEVICE = 128

# train_dtype='auto' resolves to the bf16 trunk once a batch runs wider than
# this many lanes a device (JAX batch_engine.py:370-386), or never where it
# is None, as here: at the bench model's size no width is followed by wider
# ones that all win most of their pairs on an H100 80GB HBM3 at 700 W
# (PERF.md section 5, the options; `profile_fit.py --lanes 1,16,64,128
# --train_dtype f32,bf16`, paired ms a step bf16 / f32 below 1: M = 1 in 0
# of 3 pairs, 16 in 2 of 3, 64 in 2 of 10, 128 in 3 of 10). bf16 adds a
# cast to every Linear and LayerNorm of a step that the host bounds; wide
# models take the size trigger (st_interp.AUTO_BF16_HIDDEN_SUM).
AUTO_BF16_LANES: Optional[int] = None


def _padded_lanes_per_device(M: int, n_dev: int,
                             lane_width: Optional[int]) -> int:
    """Lane width a device of a batch's program (JAX :389-398): the JAX
    engine pads a tail batch to the stream's width; the port runs a tail
    batch at its own width (`lane_width` None) on one device."""
    M_pad = M + ((-M) % n_dev)
    if (lane_width is not None and M_pad < lane_width
            and lane_width % n_dev == 0):
        M_pad = lane_width
    return M_pad // n_dev


def _apply_auto_train_dtype(cfg: ExperimentConfig,
                            setups: Sequence[ExperimentSetup],
                            lanes_per_device: int) -> None:
    """Resolve train_dtype='auto' for one batch (JAX :401-414): every
    lane's spec takes the bf16 trunk when the batch runs wider than
    AUTO_BF16_LANES lanes a device. An explicit 'f32' or 'bf16' is never
    overridden. The models are built from the specs after this."""
    if (cfg.train_dtype != "auto" or AUTO_BF16_LANES is None
            or lanes_per_device <= AUTO_BF16_LANES):
        return
    for s in setups:
        if s.spec.compute_dtype != "bf16":
            s.spec = dataclasses.replace(s.spec, compute_dtype="bf16")


def run_experiment_batch(cfg: ExperimentConfig, exp_ids: List[int],
                         experiments_dir: Path, skip_existing: bool = False,
                         verbose: bool = False,
                         device: Optional[torch.device | str] = None,
                         mesh: Any = None) -> List[Dict[str, Any]]:
    """Run all `exp_ids` of one config as lanes of one batched program; one
    results dict a lane that ran. Per-tau jobs (one model a quantile level)
    run as exp_ids x levels lanes, and then one aggregated results dict an
    experiment comes back (JAX batch_engine.py:237-266)."""
    experiments_dir = Path(experiments_dir)
    if is_per_tau(cfg):
        jobs = expand_per_tau_jobs(cfg, exp_ids, experiments_dir)
        run_lane_jobs(jobs, cfg, skip_existing=skip_existing,
                      verbose=verbose, device=device, mesh=mesh)
        # a tau lane may live on another process: the primary aggregates
        sync_processes("st_dadk_per_tau")
        if not is_primary():
            return []
        return aggregate_per_tau(cfg, exp_ids, experiments_dir,
                                 skip_existing=skip_existing,
                                 verbose=verbose)
    jobs = [(cfg, i, experiments_dir / str(i)) for i in exp_ids]
    return run_lane_jobs(jobs, cfg, skip_existing=skip_existing,
                         verbose=verbose, device=device, mesh=mesh)


def is_per_tau(cfg: ExperimentConfig) -> bool:
    """Separate-models-per-tau quantile mode."""
    return (cfg.regression_type == "quantile"
            and len(cfg.quantile_levels) > 1)


def expand_per_tau_jobs(cfg: ExperimentConfig, exp_ids: Sequence[int],
                        experiments_dir: Path) -> List[Job]:
    """One lane a (experiment, tau), written to <i>/quantile_<q>/ with its
    predictions.npz, which the aggregation reads back."""
    return [(cfg.replace(current_quantile=float(q), save_artifacts=True), i,
             Path(experiments_dir) / str(i) / f"quantile_{q}")
            for i in exp_ids for q in cfg.quantile_levels]


def aggregate_per_tau(cfg: ExperimentConfig, exp_ids: Sequence[int],
                      experiments_dir: Path, skip_existing: bool,
                      verbose: bool = False) -> List[Dict[str, Any]]:
    """Each experiment's aggregation over its tau lanes' artifacts, through
    `run_single_experiment`'s reload path. A fresh run (not
    `skip_existing`) first drops the experiment's stale top-level
    results.json, so that the reload cannot stop at it."""
    out = []
    for i in exp_ids:
        exp_dir = Path(experiments_dir) / str(i)
        if not skip_existing:
            (exp_dir / "results.json").unlink(missing_ok=True)
        out.append(run_single_experiment(cfg, i, exp_dir, verbose=verbose,
                                         skip_existing=True))
    return out


# the JAX package's list; 'config_id', 'n_jobs' and 'num_workers' are
# fields there and keys of `extra` here
_STACKABLE_KEYS = frozenset({
    "data_file", "obs_method", "obs_ratio", "obs_spatial_pattern",
    "obs_spatial_intensity", "split_method", "train_ratio",
    "normalize_target", "tag", "config_id", "base_seed", "n_experiments",
    "extra", "data_root", "save_plots", "save_artifacts", "n_jobs",
    "num_workers", "device",
    # a lane's tau: lane data when a batch mixes them, a float otherwise
    "current_quantile",
})


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def stacking_key(cfg: ExperimentConfig):
    """Configs whose non-observation fields match run the same lane program
    and may share one batch. With `k_spatial_pad` set, `k_spatial_centers`
    is a lane's own property (the program is that of the shared pad width),
    so configs that differ only in their real k layout stack. `cfg.extra`
    is part of the key: its knobs (`shuffle`, `init_subsample`,
    `init_gmm_n_init`, ...) change the init or the epoch program, and the
    engine reads them from the batch's first config; the stackable keys the
    JAX package holds as fields and the port in `extra` stay out."""
    d = dataclasses.asdict(cfg)
    skip = set(_STACKABLE_KEYS)
    if cfg.k_spatial_pad is not None:
        skip.add("k_spatial_centers")
    extra = {k: v for k, v in cfg.extra.items() if k not in _STACKABLE_KEYS}
    return tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in d.items() if k not in skip)) + (
            ("extra", _freeze(extra)),)


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
    """Run a job list at the lane width: a list wider than
    `lane_width(cfg)` lanes runs as a pipelined stream of batches of at most
    that width (`run_job_batches`)."""
    width = lane_width(cfg)
    if len(jobs) <= width:
        return run_job_batch(jobs, skip_existing=skip_existing,
                             verbose=verbose, device=device, mesh=mesh)
    batches = [jobs[i:i + width] for i in range(0, len(jobs), width)]
    return run_job_batches(batches, skip_existing=skip_existing,
                           verbose=verbose, device=device, mesh=mesh)


def run_job_batch(jobs: Sequence[Job], skip_existing: bool = False,
                  verbose: bool = False,
                  device: Optional[torch.device | str] = None,
                  mesh: Any = None) -> List[Dict[str, Any]]:
    """Run (config, experiment id, output dir) jobs as lanes of ONE program.
    All configs must share a `stacking_key`; data files and observation
    designs may differ a lane as long as dataset shapes match. With several
    processes, or a `mesh`, this process runs its own lanes only (module
    docstring)."""
    axis = jobs[0][0].mesh_axis if jobs else "exp"
    if jobs:
        jobs = owned_jobs(jobs, mesh, axis)
    prep = _prepare_job_batch(jobs, skip_existing=skip_existing,
                              device=device)
    if prep is None:
        return []
    prep["dp"] = data_group(mesh, axis, prep["device"])
    state = _execute_job_batch(prep, verbose=verbose)
    return _finalize_job_batch(state)


def owned_lane_slice(n_lanes: int, mesh: Any, axis: str = "exp") -> slice:
    """The lanes [lo, hi) of a batch of `n_lanes` that this process owns:
    all of them for one process and no mesh; else its
    `process_lane_slice` of the lane axis padded to a multiple of the
    mesh's `axis` (default mesh: every rank on `axis`, grouped by host),
    cut at the real lanes. On an `axis` x 'data' mesh (lanes nested over
    exp x data) the ranks of a data row own the same lanes; another axis of
    more than one rank raises."""
    pc, _ = process_info()
    if pc == 1 and mesh is None:
        return slice(0, n_lanes)
    mesh = mesh if mesh is not None else experiment_mesh_auto(axis)
    if axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no lane axis {axis!r}")
    other = {a: n for a, n in mesh.shape.items()
             if a not in (axis, DATA_AXIS) and n > 1}
    if other:
        raise ValueError(f"mesh {mesh.shape}: the lane engine splits lanes "
                         f"over {axis!r} and a lane's minibatch over "
                         f"{DATA_AXIS!r}; it has no use for {sorted(other)}")
    size = mesh.shape[axis]
    sl = process_lane_slice(n_lanes + (-n_lanes) % size, mesh, axis)
    return slice(min(sl.start, n_lanes), min(sl.stop, n_lanes))


def owned_jobs(jobs: Sequence[Job], mesh: Any, axis: str = "exp"
               ) -> List[Job]:
    """This process's jobs of a batch (`owned_lane_slice`)."""
    return list(jobs)[owned_lane_slice(len(jobs), mesh, axis)]


def data_group(mesh: Any, axis: str, device: torch.device
               ) -> Optional[DPGroup]:
    """The data-parallel group of this process's lanes: its row along the
    mesh's 'data' axis (`DPGroup.from_mesh`), or None where no mesh nests
    lanes over `axis` x 'data'."""
    if mesh is None or mesh.shape.get(DATA_AXIS, 1) == 1 \
            or axis == DATA_AXIS:
        return None
    return DPGroup.from_mesh(mesh, device, DATA_AXIS)


def run_job_batches(batches: Sequence[Sequence[Job]],
                    skip_existing: bool = False, verbose: bool = False,
                    device: Optional[torch.device | str] = None,
                    mesh: Any = None) -> List[Dict[str, Any]]:
    """A pipelined stream of job batches, results in job order. While batch
    k trains on the main thread (the spatial init and the fit: all of its
    device work but the finalize's predict), batch k+1's host preparation
    runs on a prepare thread and earlier batches' finalizes (the batched
    dense predict, metrics and artifacts) on a finalize thread. Finished
    finalizes are collected without waiting; at most two stay in flight, so
    trained batches cannot pile up on the device when finalize is the
    slower side. The serial baseline to measure the overlap against is a
    loop of `run_job_batch` over the batches. An exception on either thread
    is raised here. The results equal, bit for bit, those of the same
    batches through `run_job_batch` one after another: the threads share no
    random stream and no op of one batch reads another's tensors. With
    several processes or a mesh the batches run one after another on this
    thread (JAX :493-505)."""
    results: List[Dict[str, Any]] = []
    if process_info()[0] > 1 or mesh is not None:
        for jobs in batches:
            results.extend(run_job_batch(jobs, skip_existing=skip_existing,
                                         verbose=verbose, device=device,
                                         mesh=mesh))
        return results
    it = iter(batches)
    with ThreadPoolExecutor(max_workers=1) as prep_ex, \
            ThreadPoolExecutor(max_workers=1) as fin_ex:

        def submit_next_prepare():
            jobs = next(it, None)
            if jobs is None:
                return None
            return prep_ex.submit(_prepare_job_batch, jobs,
                                  skip_existing=skip_existing, device=device)

        prep_fut = submit_next_prepare()
        fin_futs: deque = deque()
        try:
            while prep_fut is not None:
                prep = prep_fut.result()
                prep_fut = submit_next_prepare()   # overlaps this training
                state = (_execute_job_batch(prep, verbose=verbose)
                         if prep is not None else None)
                while fin_futs and (fin_futs[0].done()
                                    or len(fin_futs) >= 2):
                    results.extend(fin_futs.popleft().result())
                if state is not None:
                    fin_futs.append(fin_ex.submit(_finalize_job_batch, state))
            while fin_futs:
                results.extend(fin_futs.popleft().result())
        except BaseException:
            # leave no queued work behind the failure
            for f in list(fin_futs) + ([prep_fut] if prep_fut else []):
                f.cancel()
            raise
    return results


def _prepare_job_batch(jobs: Sequence[Job], skip_existing: bool = False,
                       device: Optional[torch.device | str] = None
                       ) -> Optional[Dict[str, Any]]:
    """Host work only, so that it may run on a thread while another batch
    trains: per-lane setups (masks, point sets; the model is deferred to
    `_init_lane_carries`), the lane data stacked on the CPU and the LR
    tables. None when every job is already on disk."""
    t_start = time.time()
    todo = [(c, i, Path(d)) for c, i, d in jobs
            if not (skip_existing and (Path(d) / "results.json").exists())]
    if not todo:
        return None
    if len({stacking_key(c) for c, _, _ in todo}) != 1:
        raise ValueError("run_job_batch: configs are not stackable "
                         "(differing model/loop hyperparameters)")
    # an unset tau is the first quantile level, as on the single path
    todo = [(c.replace(current_quantile=float(c.quantile_levels[0]))
             if c.regression_type == "quantile"
             and c.current_quantile is None else c, i, d)
            for c, i, d in todo]
    cfg = todo[0][0]
    if cfg.regression_type not in ("multi-quantile", "mean", "quantile"):
        raise ValueError(f"Unknown regression_type: {cfg.regression_type}")
    if cfg.p_covariates > 0:
        raise NotImplementedError(
            "p_covariates > 0: the fit feeds no covariates")
    dev = resolve_device(device or local_device() or cfg.device)
    setups = []
    for cfg_i, exp_id, out_dir in todo:
        s = ExperimentSetup(cfg_i, exp_id, dev, verbose=False,
                            defer_model=True)
        s.out_dir = out_dir
        setups.append(s)
    shapes = {(s.T, s.S) for s in setups}
    if len(shapes) != 1:
        raise ValueError(f"run_job_batch: dataset shapes differ: {shapes}")
    _apply_auto_train_dtype(cfg, setups,
                            _padded_lanes_per_device(len(setups), 1, None))
    stacked = _stack_lane_host(cfg, setups, torch.device("cpu"))
    return dict(cfg=cfg, setups=setups, stacked=stacked, device=dev,
                t_prep=time.time() - t_start)


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
    """The lanes' padded buffers stacked on `device` (the CPU in
    `_prepare_job_batch`; `_execute_job_batch` uploads them) and their LR
    tables."""
    data = stack_lane_data(cfg, [s.train_ps for s in setups],
                           [s.valid_ps for s in setups], device)
    lr_steps, lr_recorded = _lane_lr_tables(cfg, data.n_batches,
                                            data.B_shared)
    return dict(data=data, lr_steps=lr_steps, lr_recorded=lr_recorded)


def _init_lane_carries(cfg: ExperimentConfig,
                       setups: Sequence[ExperimentSetup]
                       ) -> Tuple[STInterpLanes, List[int]]:
    """The batched spatial init and the lanes' models: (one `STInterpLanes`
    in lane order, each lane's real parameter count).

    Lanes are grouped by their real `k_spatial_centers` (one group unless
    the batch is ragged, `cfg.k_spatial_pad`); each group's init runs for
    all its lanes at once (`init_spatial_centers_batch`), every lane from
    its own generator and the numpy stream its setup left off at, so a
    lane's centers are those of its single fit. `finish_model` then draws a
    lane's params at its real shapes (the values of an unpadded run) and
    pads them to the shared width with the lane's column mask. A lane's
    `init_seconds` is its group's init over the group's lanes."""
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for i, s in enumerate(setups):
        groups.setdefault(tuple(s.cfg.k_spatial_centers), []).append(i)
    adaptive = cfg.spatial_init_method in DATA_ADAPTIVE_INIT_METHODS
    for klist, idx in groups.items():
        t0 = time.perf_counter()
        lanes = [setups[i] for i in idx]
        inits = init_spatial_centers_batch(
            cfg.spatial_init_method, list(klist),
            [s.train_ps.coords if adaptive else None for s in lanes],
            generators=[torch.Generator(device=s.device).manual_seed(
                s.experiment_seed) for s in lanes],
            rngs=[s.np_rng for s in lanes], device=lanes[0].device,
            **init_knobs(cfg))
        per_lane = (time.perf_counter() - t0) / len(lanes)
        for s, (centers, bandwidths) in zip(lanes, inits):
            s.timings["init_seconds"] = per_lane
            s.finish_model(centers, bandwidths)
    return (stack_lane_models([s.model for s in setups]),
            [s.n_params for s in setups])


def _execute_job_batch(prep: Dict[str, Any], verbose: bool = False
                       ) -> Dict[str, Any]:
    """The device side of a batch, on the caller's thread: the upload of
    the stacked lane data, the spatial init and the models of all lanes, and
    the epoch loop."""
    cfg, setups = prep["cfg"], prep["setups"]
    stacked = prep["stacked"]
    t0 = time.time()
    data: LaneData = lane_data_to(stacked["data"], prep["device"])
    lanes_model, n_params = _init_lane_carries(cfg, setups)
    t_init = time.time() - t0
    taus = ([float(s.cfg.current_quantile) for s in setups]
            if cfg.regression_type == "quantile" else None)
    # the serving params stay on the card where the device metrics will
    # score the batch and nothing else reads them (JAX :1516-1560); a
    # non-finite history, known only afterwards, pulls them at finalize
    serving = {} if _device_eval(setups) else None
    results = fit_lanes(cfg, setups[0].spec, lanes_model, data,
                        stacked["lr_steps"], stacked["lr_recorded"],
                        [s.experiment_seed for s in setups], verbose=verbose,
                        taus=taus, dp=prep.get("dp"), serving_out=serving)
    t_train = time.time() - t0 - t_init
    if verbose:
        print(f"[batch] {len(setups)} experiments x "
              f"{max(r.n_epochs_run for r in results)} epochs: host set-up "
              f"{prep['t_prep']:.1f}s, init and models {t_init:.1f}s, train "
              f"{t_train:.1f}s", flush=True)
    # the state keeps the CPU copy of the lane data: the device buffers are
    # free once the fit returns, while finalize may still wait its turn
    state = dict(prep, results=results, lanes_model=lanes_model,
                 n_params=n_params, t_init=t_init, t_train=t_train,
                 verbose=verbose, serving=serving)
    if cfg.k_spatial_pad is not None:
        _pull_serving(state)     # ragged lanes are written stripped (JAX too)
    return state


def _eval_group_key(cfg_lane: ExperimentConfig):
    """Lanes are evaluated together only when they share the actual
    dataset and target scaling."""
    return (str(cfg_lane.resolve_data_file()), bool(cfg_lane.normalize_target))


def _batched_eval(cfg: ExperimentConfig, setups: Sequence[ExperimentSetup],
                  results: Sequence[FitResult]) -> List[Dict[str, Any]]:
    """Per-lane split metrics and the dense (T, S) median field from one
    lane-batched predict of the T x S grid per distinct dataset. A chunk of
    `eval_chunk` points holds (lanes, chunk, hidden) activations. Ragged-k
    lanes predict at the shared padded width through the lane phi kernel
    with their masks, all in one launch a chunk, as the JAX engine's batched
    evaluation does: a junk column is 0 against a junk weight row of 0, so
    the field is the real-shape model's up to the order of float32 sums;
    `finalize_experiment` strips the padding from everything it writes."""
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


def _needs_field(setups: Sequence[ExperimentSetup]) -> bool:
    """A lane of the batch writes the dense field or reads it back: its
    artifacts, its figures, or a per-tau quantile lane (JAX :1516-1520)."""
    return any(s.cfg.save_artifacts or s.cfg.save_plots
               or s.cfg.regression_type == "quantile" for s in setups)


def _device_eval(setups: Sequence[ExperimentSetup]) -> bool:
    """The batch is scored by the device metrics (`_batched_eval_device`)
    where JAX scores it so: no lane needs the dense field and one process
    runs (JAX :1564-1575). A ragged batch (`k_spatial_pad`) is scored there
    too, but its params are pulled for the stripped writes, as in JAX."""
    return not _needs_field(setups) and process_info()[0] == 1


def _device_metrics(cfg: ExperimentConfig, model: STInterpLanes,
                    params: Dict[str, torch.Tensor], coords: torch.Tensor,
                    t: torch.Tensor, z: torch.Tensor, labels: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """Each lane's split metrics on the device (JAX
    `_device_metrics_program`, batch_engine.py:100-151): the lane-batched
    predict of the n grid points in chunks of `chunk` (`model` with the
    lane-stacked serving `params` in place of its own: the fused forward
    kernel, or the lane phi kernel for ragged lanes), then per split
    (labels (M, n): 1 train, 2 valid, 3 test) the weighted sums over the
    points where z (n,) is finite. Returns (M, 3, K): MSE, MAE and,
    multi-quantile, the CRPS 2 * mean_k check_k (`ops/losses.py::
    compute_crps`, Eq. 4.6, uniform weights) and the mean check loss. A
    per-tau quantile lane never comes here (`_needs_field`). The arithmetic is the
    host's (`experiment.metrics_from_preds`), where JAX's program sums in
    float32: the median's error in float32, the check losses from float64
    copies, every sum in float64. So a batch scores the same, up to the
    order of float64 sums, on either path."""
    from torch.func import functional_call
    M, n = labels.shape
    multi = cfg.regression_type == "multi-quantile"
    mid = len(cfg.quantile_levels) // 2 if multi else 0
    q = torch.tensor([float(x) for x in cfg.quantile_levels],
                     dtype=torch.float64, device=z.device)
    splits = torch.arange(1, 4, dtype=labels.dtype, device=z.device)
    cnt = torch.zeros((M, 3), dtype=torch.float64, device=z.device)
    se, ae, chk = cnt.clone(), cnt.clone(), None
    for s in range(0, n, chunk):
        c = coords[s:s + chunk].expand(M, -1, -1).contiguous()
        tt = t[s:s + chunk].expand(M, -1, -1).contiguous()
        preds = functional_call(model, params, (c, tt), {"train": False})
        zc = z[s:s + chunk]
        finite = torch.isfinite(zc)
        zz = torch.where(finite, zc, torch.zeros_like(zc))
        err = (preds[..., mid] - zz).double()                    # (M, c)
        w = ((labels[:, s:s + chunk, None] == splits)
             & finite[None, :, None]).double()                   # (M, c, 3)
        cnt = cnt + w.sum(dim=1)
        se = se + torch.bmm((err * err)[:, None, :], w)[:, 0]
        ae = ae + torch.bmm(torch.abs(err)[:, None, :], w)[:, 0]
        if multi:
            e_k = zz.double()[None, :, None] - preds.double()    # (M, c, Q)
            rho = torch.maximum((q - 1.0) * e_k, q * e_k)
            part = torch.bmm(w.transpose(1, 2), rho)             # (M, 3, Q)
            chk = part if chk is None else chk + part
    cnt = torch.clamp(cnt, min=1.0)
    cols = [se / cnt, ae / cnt]
    if multi:
        checks = chk / cnt[..., None]
        cols += [2.0 * checks.mean(dim=-1), checks.mean(dim=-1)]
    return torch.stack(cols, dim=-1)


def _batched_eval_device(cfg: ExperimentConfig,
                         setups: Sequence[ExperimentSetup],
                         model: STInterpLanes,
                         params: Dict[str, torch.Tensor]
                         ) -> List[Dict[str, Any]]:
    """Per-lane split metrics with everything on the device (JAX
    `_batched_eval_device`, batch_engine.py:154-226): one `_device_metrics`
    call per distinct dataset, and only its (M, 3, K) scalars cross to the
    host. `params` are the lane-stacked serving params of
    `fit_lanes(serving_out=...)`. No dense field: valid where no lane
    needs it (`_device_eval`)."""
    groups: Dict[Any, List[int]] = {}
    for li, s in enumerate(setups):
        groups.setdefault(_eval_group_key(s.cfg), []).append(li)
    out: List[Optional[Dict[str, Any]]] = [None] * len(setups)
    dev = setups[0].device
    for lanes in groups.values():
        s0 = setups[lanes[0]]
        coords_rep, t_rep = dense_grid_points(s0.T, s0.coords)
        grid = tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                     device=dev) for a in
                     (coords_rep, t_rep.reshape(-1, 1), s0.z_full.ravel()))
        labels = torch.as_tensor(np.stack([
            setups[li].train_mask.ravel().astype(np.int8)
            + setups[li].valid_mask.ravel().astype(np.int8) * 2
            + setups[li].test_mask.ravel().astype(np.int8) * 3
            for li in lanes]), device=dev)
        idx = torch.as_tensor(lanes, device=dev)
        whole = len(lanes) == len(setups)
        vals = _device_metrics(
            cfg, model if whole else select_lanes(model, idx),
            params if whole else {k: v[idx] for k, v in params.items()},
            *grid, labels, int(cfg.eval_chunk)).cpu().numpy()
        for gi, li in enumerate(lanes):
            lane = {}
            for si, split in enumerate(("train_metrics", "val_metrics",
                                        "test_metrics")):
                row = vals[gi, si]
                m = {"mse": float(row[0]), "mae": float(row[1]),
                     "rmse": float(np.sqrt(row[0]))}
                if cfg.regression_type == "multi-quantile":
                    m["crps"] = float(row[2])
                    m["mean_check_loss"] = float(row[3])
                    m["check_loss"] = float(row[3])
                lane[split] = m
            out[li] = lane
    return out


def _pull_serving(state: Dict[str, Any]) -> List[FitResult]:
    """The batch's FitResults with their serving params and final EMA on
    the host, pulled from the device once where `fit_lanes` kept them
    there (state['serving'])."""
    serving = state.get("serving")
    if serving and state["results"][0].params is None:
        params = pull_lane_params(serving["params"])
        final = pull_lane_params(serving["final_ema"])
        state["results"] = [r._replace(params=p, final_ema=f) for r, p, f
                            in zip(state["results"], params, final)]
    return state["results"]


# device evaluations that raised and fell back to the per-lane one, since
# the process began: a caller that needs the batched path reads it
eval_fallbacks = 0


def _finalize_job_batch(state: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Batched evaluation, then every lane's results contract through
    `finalize_experiment`. A lane's `total_time_seconds` is the batch's own
    work (host set-up, init, training, evaluation: not the time it waited in
    a pipeline) divided by its lanes.

    The evaluation is the device metrics (`_batched_eval_device`) where
    `_device_eval` holds, and the serving params then stay on the device
    unless a lane's history is non-finite (its NaN diagnostics read them);
    else the dense predict of `_batched_eval` on pulled params. If the
    device metrics raise, a warning is printed, `eval_fallbacks` counts
    it, the params are pulled and each lane is evaluated on its own (JAX
    :1576-1582); the host path raises as it is. In a
    data-parallel row (lanes nested over exp x data) the row's rank 0
    alone finalizes and writes; the others return no results."""
    global eval_fallbacks
    cfg, setups = state["cfg"], state["setups"]
    dp = state.get("dp")
    if dp is not None and not dp.primary:
        return []
    M = len(setups)
    t_phase = time.time()
    device_eval = state.get("serving") is not None
    if device_eval and any(not np.all(np.isfinite(r.history["train_loss"]))
                           for r in state["results"]):
        _pull_serving(state)
    if not device_eval:
        precomputed = _batched_eval(cfg, setups, state["results"])
    else:
        try:
            precomputed = _batched_eval_device(
                cfg, setups, state["lanes_model"], state["serving"]["params"])
        except Exception as e:   # noqa: BLE001 (JAX's fallback, as it has it)
            eval_fallbacks += 1
            print(f"[WARNING] batched eval failed, falling back per-lane: "
                  f"{e}", flush=True)
            precomputed = None
            _pull_serving(state)
    results = state["results"]
    t_eval = time.time() - t_phase
    t_setup = state["t_prep"] + state["t_init"]
    wall = t_setup + state["t_train"] + t_eval
    out = []
    for li, (s, fit_res) in enumerate(zip(setups, results)):
        s.out_dir.mkdir(parents=True, exist_ok=True)
        r = finalize_experiment(
            s.cfg, s, fit_res, s.out_dir, wall / M, verbose=False,
            stage_timings={"setup_seconds": t_setup / M, **s.timings,
                           "train_seconds": state["t_train"] / M,
                           "batch_lanes": M,
                           "batch_setup_seconds": t_setup,
                           "batch_prepare_seconds": state["t_prep"],
                           "batch_init_seconds": state["t_init"],
                           "batch_train_seconds": state["t_train"],
                           "batch_eval_seconds": t_eval,
                           **fit_res.timings},
            precomputed=precomputed[li] if precomputed else None,
            steps_per_epoch=state["stacked"]["data"].B_shared)
        # a quantile lane's split predictions: the per-tau aggregation
        # reads them back from predictions.npz
        r.pop("_split_predictions", None)
        if r["model_parameters"] != state["n_params"][li]:
            raise RuntimeError(
                f"lane {li}: the stripped model holds "
                f"{r['model_parameters']} parameters, its real shapes "
                f"{state['n_params'][li]}")
        out.append(r)
    # known only once the last lane is written: in the returned dicts, not
    # in results.json
    for r in out:
        r["stage_timings"]["batch_finalize_seconds"] = time.time() - t_phase
    if state["verbose"]:
        print(f"[batch] finalize (eval + artifacts) "
              f"{time.time() - t_phase:.1f}s", flush=True)
    return out
