"""Single-experiment runner: data -> masks -> spatial init -> fit -> eval
(port of `st_dadk_tpu/train/experiment.py`).

Seeding matches the JAX package: experiment seed = base_seed + id - 1; the
observation mask draws with that seed and the train/valid split with seed +
10000, so the masks are identical. Writes `results.json` (the JAX keys plus
the fit's step count, validation chunks and per-epoch center shift) and
`training_history.csv`; with `save_artifacts`, also model_{final,best}.npz,
predictions.npz and basis_info.npz; with `save_plots` (the default, as in
JAX), the figures of `viz/plots.py`, each family inside one try as JAX's
finalize has them (experiment.py:636-662): a figure never fails a fit, and
where one raises (no matplotlib, say) the fit prints JAX's warning and
writes no more figures. After a NaN-poisoned epoch, `nan_diagnostics.json`
holds the poisoned epochs and the statistics of the serving and final
params and of the training inputs (JAX experiment.py:380-431, :567-577).

A ragged-k lane (`k_spatial_pad`) draws its params at its real shapes, fits
padded to the shared width through the materialised-phi kernels, and is
stripped back to its real shapes before evaluation and the artifacts.

`regression_type: quantile` with several levels fits one model a level in
`quantile_<q>/` and writes the JAX package's aggregated `results.json`
beside them, with the CRPS over the tau models (experiment.py:152-246),
and the combined fan chart of the tau models' fields.
"""
from __future__ import annotations

import csv
import dataclasses
import json
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from st_dadk_tpu_torch.config import ExperimentConfig, resolve_device
from st_dadk_tpu_torch.dataio.arrays import (PointSet, dense_grid_points,
                                             pointset_from_mask)
from st_dadk_tpu_torch.dataio.kaust import load_kaust_csv_single
from st_dadk_tpu_torch.dataio.obs_design import (sample_observations,
                                                 spatial_obs_probs,
                                                 split_train_valid)
from st_dadk_tpu_torch.models.st_interp import (ModelSpec, STInterp,
                                                count_parameters,
                                                from_jax_params, init_model,
                                                model_consts, pad_lane_model,
                                                spec_from_config,
                                                strip_lane_padding,
                                                to_jax_params)
from st_dadk_tpu_torch.ops.init_centers import (DATA_ADAPTIVE_INIT_METHODS,
                                                init_spatial_centers)
from st_dadk_tpu_torch.parallel.data_parallel import DPGroup
from st_dadk_tpu_torch.ops.losses import (check_loss_np, compute_crps,
                                          compute_crps_multi_quantile)
from st_dadk_tpu_torch.train.loop import (FitResult, adaptive_batch_size, fit,
                                          predict)
from st_dadk_tpu_torch.utils.io import save_json


def _flatten_params(params: Dict[str, Any], prefix: str = ""
                    ) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_params(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def save_params_npz(params: Dict[str, Any], path: Path) -> None:
    np.savez(path, **_flatten_params(params))


def load_params_npz(path: Path) -> Dict[str, Any]:
    flat = np.load(path)
    params: Dict[str, Any] = {}
    for name in flat.files:
        parts = name.split(".")
        node = params
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = flat[name]
    return params


def metrics_from_preds(cfg: ExperimentConfig, preds: np.ndarray,
                       trues: np.ndarray) -> Dict[str, float]:
    """RMSE/MAE/MSE of the median quantile (or the single head), plus the
    check loss of a quantile fit and CRPS and check losses for
    multi-quantile fits."""
    if cfg.regression_type == "multi-quantile":
        mid = len(cfg.quantile_levels) // 2
        preds_m = preds[:, mid:mid + 1]
    else:
        preds_m = preds
    mse = float(np.mean((preds_m - trues) ** 2))
    metrics = {"mse": mse, "mae": float(np.mean(np.abs(preds_m - trues))),
               "rmse": float(np.sqrt(mse))}
    if cfg.regression_type == "quantile" and cfg.current_quantile is not None:
        metrics["check_loss"] = check_loss_np(preds.ravel(), trues.ravel(),
                                              float(cfg.current_quantile))
    if cfg.regression_type == "multi-quantile":
        metrics["crps"] = float(compute_crps_multi_quantile(
            preds, trues, cfg.quantile_levels))
        checks = [check_loss_np(preds[:, i], trues.ravel(), q)
                  for i, q in enumerate(cfg.quantile_levels)]
        metrics["mean_check_loss"] = float(np.mean(checks))
        metrics["check_loss"] = float(np.mean(checks))
    return metrics


def evaluate_pointset(cfg: ExperimentConfig, model: STInterp, ps: PointSet,
                      chunk: int = 32768
                      ) -> Tuple[Dict[str, float], np.ndarray]:
    preds = predict(model, ps.coords, ps.t, chunk)
    return metrics_from_preds(cfg, preds, ps.y), preds


def init_knobs(cfg: ExperimentConfig) -> Dict[str, Any]:
    """The JAX init knobs of `cfg.extra` as `init_spatial_centers(_batch)`
    arguments (JAX experiment.py:304-308)."""
    return {"subsample": cfg.extra.get("init_subsample"),
            "gmm_n_init": cfg.extra.get("init_gmm_n_init"),
            "seed_rounds": cfg.extra.get("init_seed_rounds"),
            "em_dtype": cfg.extra.get("init_em_dtype")}


class ExperimentSetup:
    """Data, masks, point sets and the initialised model of one fit on
    `device` (`config.resolve_device`)."""

    def __init__(self, cfg: ExperimentConfig, experiment_id: int,
                 device: torch.device | str, verbose: bool = False,
                 defer_model: bool = False):
        t0 = time.perf_counter()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.experiment_id = experiment_id
        self.experiment_seed = cfg.base_seed + experiment_id - 1

        self.z_full, self.coords, self.metadata = _load_cached(
            cfg.resolve_data_file(), cfg.normalize_target, verbose)
        self.T, self.S = self.z_full.shape
        obs_weights = spatial_obs_probs(self.coords, cfg.obs_spatial_pattern,
                                        cfg.obs_spatial_intensity)
        self.obs_mask, obs_sites = sample_observations(
            self.z_full, self.coords, cfg.obs_method, cfg.obs_ratio,
            obs_weights, seed=self.experiment_seed)
        # the split's stream continues into the init subsample, as the
        # reference's global numpy stream does
        self.np_rng = np.random.RandomState(self.experiment_seed + 10000)
        self.train_mask, self.valid_mask = split_train_valid(
            self.obs_mask, obs_sites, cfg.split_method, cfg.train_ratio,
            rng=self.np_rng)
        self.test_mask = ~self.obs_mask
        self.train_ps = pointset_from_mask(self.z_full, self.coords,
                                           self.train_mask)
        self.valid_ps = pointset_from_mask(self.z_full, self.coords,
                                           self.valid_mask)
        self.test_ps = pointset_from_mask(self.z_full, self.coords,
                                          self.test_mask)
        self.spec: ModelSpec = spec_from_config(cfg)
        self.model: Optional[STInterp] = None
        self.n_params = 0
        self.timings = {"data_seconds": time.perf_counter() - t0}
        if not defer_model:
            t1 = time.perf_counter()
            train_coords = (self.train_ps.coords
                            if cfg.spatial_init_method in
                            DATA_ADAPTIVE_INIT_METHODS else None)
            gen = torch.Generator(device=self.device).manual_seed(
                self.experiment_seed)
            centers, bandwidths = init_spatial_centers(
                cfg.spatial_init_method, cfg.k_spatial_centers, train_coords,
                generator=gen, device=self.device, rng=self.np_rng,
                **init_knobs(cfg))
            self.timings["init_seconds"] = time.perf_counter() - t1
            self.finish_model(centers, bandwidths)

    def finish_model(self, centers: np.ndarray, bandwidths: np.ndarray) -> None:
        """Initialise the model from the spatial init. A ragged-k lane
        (`k_spatial_pad`) draws its params at the lane's real shapes (the
        values of an unpadded run) and pads them to the shared width
        (`pad_lane_model`, JAX experiment.py:311-333). `n_params` is the
        parameter count at the real shapes."""
        gen = torch.Generator().manual_seed(self.experiment_seed)
        if self.cfg.k_spatial_pad is None:
            self.model = init_model(gen, self.spec, centers, bandwidths,
                                    device=self.device)
            self.n_params = count_parameters(self.model)
            return
        spec_real = real_lane_spec(self.cfg, self.spec)
        # the real-shape model only carries its values into pad_lane_model
        real = init_model(gen, spec_real, centers, bandwidths, device="cpu")
        self.n_params = count_parameters(real)
        params, consts = pad_lane_model(spec_real, int(self.cfg.k_spatial_pad),
                                        to_jax_params(real), model_consts(real))
        self.model = from_jax_params(self.spec, params, consts,
                                     device=self.device)


_CSV_CACHE: Dict[Tuple[str, bool, int, int],
                 Tuple[np.ndarray, np.ndarray, Dict[str, Any]]] = {}


def _load_cached(path: Path, normalize: bool, verbose: bool
                 ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """Load-once cache (JAX experiment.py:339): the repeats of a config and
    the lanes of a batch share one parse of their CSV. The key holds the
    file's size and modification time, so a rewritten file is read again.
    The arrays are shared: every consumer reads them only."""
    st = Path(path).stat()
    key = (str(path), bool(normalize), st.st_size, st.st_mtime_ns)
    if key not in _CSV_CACHE:
        _CSV_CACHE[key] = load_kaust_csv_single(path, normalize=normalize,
                                                verbose=verbose)
    return _CSV_CACHE[key]


def real_lane_spec(cfg: ExperimentConfig, spec: ModelSpec) -> ModelSpec:
    """The real-shape spec of a ragged-k lane: its own resolutions, and
    still the materialised-phi route of a padded lane."""
    return dataclasses.replace(
        spec, k_spatial_centers=tuple(cfg.k_spatial_centers))


def run_single_experiment(config: ExperimentConfig | Dict[str, Any],
                          experiment_id: int, output_dir: Path,
                          device: Optional[torch.device | str] = None,
                          verbose: bool = True,
                          write_artifacts: bool = True,
                          skip_existing: bool = False,
                          dp: Optional[DPGroup] = None) -> Dict[str, Any]:
    """One experiment end to end on `device` (default: the config's; with
    `dp`, the data-parallel fit over its ranks on the rank's device). A
    multi-quantile or mean fit, or a quantile fit of one level (its tau the
    first level unless `current_quantile` names one), is one fit; a
    quantile fit of several levels is one fit a level in `quantile_<q>/`,
    aggregated (`_run_per_tau`). With `skip_existing`, a `results.json`
    already in `output_dir` is returned as stored and nothing runs (JAX
    experiment.py:147-150)."""
    cfg = (config if isinstance(config, ExperimentConfig)
           else ExperimentConfig.from_dict(config))
    output_dir = Path(output_dir)
    if skip_existing and (output_dir / "results.json").exists():
        with open(output_dir / "results.json", "r", encoding="utf-8") as f:
            return json.load(f)
    if cfg.regression_type not in ("multi-quantile", "mean", "quantile"):
        raise ValueError(f"Unknown regression_type: {cfg.regression_type}")
    if cfg.p_covariates > 0:
        # covariates are model-level only, as in JAX: its fit feeds none
        # (st_dadk_tpu/train/loop.py:226 calls forward with X=None)
        raise NotImplementedError(
            "p_covariates > 0: the fit feeds no covariates (JAX "
            "train/loop.py:226 passes X=None); STInterp takes X directly")
    output_dir.mkdir(parents=True, exist_ok=True)
    if cfg.regression_type == "quantile" and len(cfg.quantile_levels) > 1:
        return _run_per_tau(cfg, experiment_id, output_dir, device, verbose,
                            write_artifacts, skip_existing, dp)
    if cfg.regression_type == "quantile" and cfg.current_quantile is None:
        cfg = cfg.replace(current_quantile=float(cfg.quantile_levels[0]))
    return _run_one_fit(cfg, experiment_id, output_dir,
                        _fit_device(cfg, device, dp), verbose,
                        write_artifacts, dp)


def _fit_device(cfg: ExperimentConfig, device, dp: Optional[DPGroup]
                ) -> torch.device:
    return dp.device if dp is not None else resolve_device(device
                                                           or cfg.device)


def _split_predictions(pred: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A tau model's dense field cut to the three splits, with the truth:
    what the CRPS over the tau models reads (a predictions.npz's keys)."""
    field, true = pred["predictions"], pred["true"]
    out = {}
    for split in ("train", "test", "valid"):
        mask = pred[f"{split}_mask"]
        out[split], out[f"{split}_true"] = field[mask], true[mask]
    return out


def _run_per_tau(cfg: ExperimentConfig, experiment_id: int, output_dir: Path,
                 device: Optional[torch.device | str], verbose: bool,
                 write_artifacts: bool, skip_existing: bool,
                 dp: Optional[DPGroup] = None) -> Dict[str, Any]:
    """One model a quantile level in `quantile_<q>/` (a level already on
    disk with its predictions.npz is reloaded under `skip_existing`), then
    the JAX package's aggregated results (experiment.py:159-224): CRPS over
    the tau models' split predictions, and the means over levels of their
    check losses and MAEs. As there, `*_mse` is the mean check loss and
    `*_rmse` its square root."""
    quantile_results: Dict[float, Dict[str, Any]] = {}
    quantile_preds: Dict[float, Dict[str, np.ndarray]] = {}
    for q in cfg.quantile_levels:
        q_dir = output_dir / f"quantile_{q}"
        q_dir.mkdir(parents=True, exist_ok=True)
        if skip_existing and (q_dir / "results.json").exists() \
                and (q_dir / "predictions.npz").exists():
            with open(q_dir / "results.json", "r", encoding="utf-8") as f:
                quantile_results[q] = json.load(f)
            quantile_preds[q] = _split_predictions(
                np.load(q_dir / "predictions.npz"))
            continue
        q_cfg = cfg.replace(regression_type="quantile", current_quantile=q)
        r = _run_one_fit(q_cfg, experiment_id, q_dir,
                         _fit_device(cfg, device, dp), verbose,
                         write_artifacts, dp)
        quantile_preds[q] = r.pop("_split_predictions")
        quantile_results[q] = r

    qs = list(cfg.quantile_levels)
    crps = {}
    for split in ("train", "test", "valid"):
        crps[split] = compute_crps({q: quantile_preds[q][split] for q in qs},
                                   quantile_preds[qs[0]][f"{split}_true"])

    def mean_of(key):
        return float(np.mean([quantile_results[q].get(
            key, quantile_results[q].get(key.replace("check_loss", "mse"),
                                         0.0)) for q in qs]))

    aggregated = {
        "experiment_id": experiment_id,
        "regression_type": "quantile",
        "quantile_levels": qs,
        "quantile_results": quantile_results,
        "train_crps": float(crps["train"]),
        "test_crps": float(crps["test"]),
        "valid_crps": float(crps["valid"]),
        "train_check_loss": mean_of("train_check_loss"),
        "test_check_loss": mean_of("test_check_loss"),
        "valid_check_loss": mean_of("valid_check_loss"),
        "test_mse": mean_of("test_check_loss"),
        "valid_mse": mean_of("valid_check_loss"),
        "train_mse": mean_of("train_check_loss"),
        "test_rmse": float(np.sqrt(mean_of("test_check_loss"))),
        "valid_rmse": float(np.sqrt(mean_of("valid_check_loss"))),
        "train_rmse": float(np.sqrt(mean_of("train_check_loss"))),
        "test_mae": mean_of("test_mae"),
        "valid_mae": mean_of("valid_mae"),
        "train_mae": mean_of("train_mae"),
        "total_time_seconds": float(np.sum(
            [quantile_results[q].get("total_time_seconds", 0) for q in qs])),
    }
    if write_artifacts:
        save_json(aggregated, output_dir / "results.json")
    if cfg.save_plots and cfg.save_artifacts and write_artifacts:
        try:
            from st_dadk_tpu_torch.viz.plots import \
                plot_combined_quantile_series
            qpred, z_full = {}, None
            for q in qs:
                f = output_dir / f"quantile_{q}" / "predictions.npz"
                if f.exists():
                    d = np.load(f)
                    qpred[q] = d["predictions"]
                    z_full, coords = d["true"], d["coords"]
                    train_mask, test_mask = d["train_mask"], d["test_mask"]
            if len(qpred) == len(qs) and z_full is not None:
                plot_combined_quantile_series(qpred, z_full, coords,
                                              train_mask, test_mask,
                                              output_dir)
        except Exception as e:   # a figure never fails the experiment
            print(f"[WARNING] combined quantile plot failed: {e}")
    return aggregated


def _run_one_fit(cfg: ExperimentConfig, experiment_id: int, output_dir: Path,
                 device: torch.device, verbose: bool,
                 write_artifacts: bool,
                 dp: Optional[DPGroup] = None) -> Dict[str, Any]:
    start = time.time()
    setup = ExperimentSetup(cfg, experiment_id, device, verbose)
    t_setup = time.time() - start
    if verbose:
        print(f"[EXP {experiment_id}] seed={setup.experiment_seed} "
              f"data={cfg.data_file} type={cfg.regression_type} "
              f"train/valid/test: {setup.train_ps.n_real}/"
              f"{setup.valid_ps.n_real}/{setup.test_ps.n_real}", flush=True)
    t0 = time.time()
    result = fit(cfg, setup.spec, setup.model, setup.train_ps, setup.valid_ps,
                 seed=setup.experiment_seed, verbose=verbose, dp=dp)
    t_train = time.time() - t0
    return finalize_experiment(
        cfg, setup, result, output_dir, time.time() - start, verbose=verbose,
        stage_timings={"setup_seconds": t_setup, **setup.timings,
                       "train_seconds": t_train, **result.timings},
        write_artifacts=write_artifacts)


def finalize_experiment(cfg: ExperimentConfig, setup: ExperimentSetup,
                        result: FitResult, output_dir: Path,
                        total_time: float, verbose: bool = False,
                        stage_timings: Optional[Dict[str, float]] = None,
                        write_artifacts: bool = True,
                        precomputed: Optional[Dict[str, Any]] = None,
                        steps_per_epoch: Optional[int] = None
                        ) -> Dict[str, Any]:
    """Evaluate the serving params on the three splits and write the
    results contract. A ragged-k lane is stripped of its padding first
    (JAX experiment.py:460-479), so evaluation, `model_parameters` and every
    artifact carry the lane's real shapes. `precomputed` (the lane engine's
    batched evaluation) holds 'train_metrics', 'val_metrics', 'test_metrics'
    and the dense median field 'all_predictions' (T, S), which then are not
    computed again; `steps_per_epoch` is the batch's shared step count
    where it differs from this fit's own. A quantile fit's returned dict
    also holds '_split_predictions' (see `_run_per_tau`). A lane scored by
    the device metrics comes with `result.params` None (the params stayed
    on the card): it then needs `precomputed` and writes no artifact or
    figure, and its `model_parameters` is the setup's `n_params`."""
    t_eval = time.time()
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    spec = setup.spec
    params, consts = result.params, model_consts(setup.model)
    if cfg.k_spatial_pad is not None:
        spec = real_lane_spec(cfg, spec)
        k_pad = int(cfg.k_spatial_pad)
        params, consts_real = strip_lane_padding(spec, k_pad, params, consts)
        final_ema = (None if result.final_ema is None else
                     strip_lane_padding(spec, k_pad, result.final_ema,
                                        consts)[0])
        result = result._replace(
            params=params, final_ema=final_ema,
            centers_history=tuple((e, np.asarray(c)[:spec.k_spatial])
                                  for e, c in result.centers_history))
        consts = consts_real
    if params is None:
        if precomputed is None or (write_artifacts and (
                cfg.save_artifacts or cfg.save_plots)) \
                or cfg.regression_type == "quantile":
            raise ValueError("finalize_experiment: no params, and the "
                             "metrics or the writes need them")
        serving = None
    else:
        serving = from_jax_params(spec, params, consts, device=setup.device)
    chunk = int(cfg.eval_chunk)

    if precomputed is not None:
        train_metrics = precomputed["train_metrics"]
        val_metrics = precomputed["val_metrics"]
        test_metrics = precomputed["test_metrics"]
    else:
        train_metrics, _ = evaluate_pointset(cfg, serving, setup.train_ps,
                                             chunk)
        val_metrics, _ = evaluate_pointset(cfg, serving, setup.valid_ps, chunk)
        test_metrics, _ = evaluate_pointset(cfg, serving, setup.test_ps, chunk)
    if verbose:
        print(f"  test: {test_metrics}", flush=True)

    history = {k: result.history[k].tolist()
               for k in ("train_loss", "val_loss", "val_rmse", "lr")}
    config_with_dir = cfg.to_dict()
    config_with_dir["output_dir"] = str(output_dir)
    results: Dict[str, Any] = {
        "experiment_id": setup.experiment_id,
        "experiment_seed": setup.experiment_seed,
        "config": config_with_dir,
        "metrics": {"train": train_metrics, "valid": val_metrics,
                    "test": test_metrics},
        "training_history": history,
        "total_time_seconds": total_time,
        "total_time_formatted": (f"{int(total_time // 3600):02d}:"
                                 f"{int((total_time % 3600) // 60):02d}:"
                                 f"{int(total_time % 60):02d}"),
        "model_parameters": (setup.n_params if serving is None
                             else count_parameters(serving)),
        "timestamp": datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        "n_epochs_run": result.n_epochs_run,
        "stage_timings": dict(stage_timings or {}),
        "device": str(setup.device),
        "n_steps": result.n_steps,
        "n_val_chunks": result.n_val_chunks,
        "n_points": {"train": setup.train_ps.n_real,
                     "valid": setup.valid_ps.n_real,
                     "test": setup.test_ps.n_real,
                     "dense": (setup.T * setup.S if cfg.save_artifacts
                               and write_artifacts else 0)},
        "basis_center_shift": result.center_shift.tolist(),
    }
    results["stage_timings"]["eval_seconds"] = time.time() - t_eval
    train_s = results["stage_timings"].get("train_seconds")
    if train_s:
        if steps_per_epoch is None:
            bs = adaptive_batch_size(setup.train_ps.n_real, cfg.batch_size)
            steps_per_epoch = max(1, -(-setup.train_ps.n_real // bs))
        results["steps_per_second"] = (result.n_epochs_run * steps_per_epoch
                                       / train_s)
    for split, m in (("train", train_metrics), ("valid", val_metrics),
                     ("test", test_metrics)):
        results[f"{split}_mse"] = m["mse"]
        results[f"{split}_mae"] = m["mae"]
        results[f"{split}_rmse"] = m["rmse"]
    if cfg.regression_type == "quantile":
        results["regression_type"] = "quantile"
        results["quantile_level"] = cfg.current_quantile
        for split, m in (("train", train_metrics), ("valid", val_metrics),
                         ("test", test_metrics)):
            results[f"{split}_check_loss"] = m.get("check_loss", m["mse"])
        # the check loss stands in for the MSE in the flat keys (JAX
        # experiment.py:556-558)
        results["test_mse"] = test_metrics.get("check_loss",
                                               test_metrics["mse"])
        results["valid_mse"] = val_metrics.get("check_loss",
                                               val_metrics["mse"])
    elif cfg.regression_type == "multi-quantile":
        results["regression_type"] = "multi-quantile"
        results["quantile_levels"] = list(cfg.quantile_levels)
        for split, m in (("train", train_metrics), ("valid", val_metrics),
                         ("test", test_metrics)):
            results[f"{split}_crps"] = m["crps"]
            results[f"{split}_check_loss"] = m["mean_check_loss"]

    nan_epochs = np.flatnonzero(~np.isfinite(
        np.asarray(result.history["train_loss"], np.float64)))
    if nan_epochs.size and write_artifacts:
        _write_nan_diagnostics(output_dir, result, setup, nan_epochs)
        if verbose:
            print(f"[WARNING] NaN train loss in epochs "
                  f"{nan_epochs.tolist()}; diagnostics -> "
                  f"{output_dir / 'nan_diagnostics.json'}")

    if write_artifacts:
        save_json(results, output_dir / "results.json")
        with open(output_dir / "training_history.csv", "w", newline="",
                  encoding="utf-8") as f:
            wr = csv.writer(f)
            wr.writerow(["epoch", "train_loss", "val_loss", "val_rmse", "lr"])
            for i in range(len(history["train_loss"])):
                wr.writerow([i + 1, history["train_loss"][i],
                             history["val_loss"][i], history["val_rmse"][i],
                             history["lr"][i]])
    # the dense median (or single-head) field: an artifact, and the split
    # predictions a per-tau aggregation reads
    field = (precomputed or {}).get("all_predictions")
    quantile = cfg.regression_type == "quantile"
    if field is None and (quantile or (cfg.save_artifacts
                                       and write_artifacts)):
        coords_rep, t_rep = dense_grid_points(setup.T, setup.coords)
        dense = predict(serving, coords_rep, t_rep, chunk)
        col = (len(cfg.quantile_levels) // 2
               if cfg.regression_type == "multi-quantile" else 0)
        field = dense[:, col].reshape(setup.T, setup.S)
    if cfg.save_artifacts and write_artifacts:
        save_params_npz(params, output_dir / "model_final.npz")
        save_params_npz(params, output_dir / "model_best.npz")
        np.savez(output_dir / "predictions.npz", predictions=field,
                 true=setup.z_full, coords=setup.coords,
                 train_mask=setup.train_mask, valid_mask=setup.valid_mask,
                 test_mask=setup.test_mask)
        init_c = consts["spatial_centers_init"]
        init_bw = consts["spatial_bandwidths_init"]
        final_c, final_bw = _final_basis(spec, params, consts)
        np.savez(output_dir / "basis_info.npz",
                 spatial_centers_init=init_c, spatial_centers_final=final_c,
                 spatial_bandwidths_init=init_bw,
                 spatial_bandwidths_final=final_bw,
                 temporal_centers_init=consts["temporal_centers"],
                 temporal_centers_final=consts["temporal_centers"],
                 temporal_bandwidths_init=consts["temporal_bandwidths"],
                 temporal_bandwidths_final=consts["temporal_bandwidths"])
    if cfg.save_plots and write_artifacts:
        try:
            _write_figures(cfg, spec, setup, result, serving, params,
                           consts, history, field, output_dir)
        except Exception as e:  # a figure never fails the experiment
            print(f"[WARNING] plotting failed: {e}")
    if verbose:
        print(f"[EXP {setup.experiment_id}] done in "
              f"{results['total_time_formatted']} -> {output_dir}", flush=True)
    if quantile:
        # for the CRPS over the tau models; not in results.json
        results["_split_predictions"] = _split_predictions(dict(
            predictions=field, true=setup.z_full,
            train_mask=setup.train_mask, valid_mask=setup.valid_mask,
            test_mask=setup.test_mask))
    return results


def _final_basis(spec: ModelSpec, params: Dict[str, Any],
                 consts: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
    """(centers, bandwidths) after training: the learned ones, else the
    initial ones."""
    if spec.spatial_learnable:
        return (np.asarray(params["basis"]["centers"]),
                np.exp(np.asarray(params["basis"]["log_bandwidths"])))
    return (np.asarray(consts["spatial_centers_init"]),
            np.asarray(consts["spatial_bandwidths_init"]))


def _write_figures(cfg: ExperimentConfig, spec: ModelSpec,
                   setup: ExperimentSetup, result: FitResult,
                   serving: STInterp, params: Dict[str, Any],
                   consts: Dict[str, Any], history: Dict[str, list],
                   field: Optional[np.ndarray], output_dir: Path) -> None:
    """The per-experiment figures of JAX's finalize (experiment.py:636-662)
    in its order; the first that raises ends the family."""
    from st_dadk_tpu_torch.viz import plots
    plots.plot_training_curves(history, output_dir / "training_curves.png")
    plots.plot_observation_pattern(setup.coords, setup.obs_mask,
                                   setup.train_mask, setup.valid_mask,
                                   output_dir)
    plots.plot_predictions(cfg, serving, setup.z_full, setup.coords,
                           setup.train_mask, output_dir)
    if field is None:
        coords_rep, t_rep = dense_grid_points(setup.T, setup.coords)
        dense = predict(serving, coords_rep, t_rep, int(cfg.eval_chunk))
        col = (len(cfg.quantile_levels) // 2
               if cfg.regression_type == "multi-quantile" else 0)
        field = dense[:, col].reshape(setup.T, setup.S)
    plots.plot_spatial_mse(setup.z_full, setup.coords, field,
                           setup.train_mask, output_dir)
    plots.plot_temporal_series(cfg, serving, setup.z_full, setup.coords,
                               setup.train_mask, setup.valid_mask,
                               setup.test_mask, output_dir)
    inactive = plots.inactive_basis_mask(
        np.asarray(params["mlp"]["linear_0"]["w"]), spec.k_spatial, spec.p,
        float(cfg.extra.get("sparsity_threshold_ratio", 0.01)))
    plots.plot_basis_evolution(
        np.asarray(consts["spatial_centers_init"]),
        np.asarray(consts["spatial_bandwidths_init"]),
        *_final_basis(spec, params, consts), setup.train_ps.coords,
        output_dir, list(result.centers_history), inactive=inactive)


def _tensor_stats(arr: np.ndarray) -> Dict[str, Any]:
    a = np.asarray(arr, np.float64)
    finite = np.isfinite(a)
    fa = a[finite]
    return {
        "shape": list(a.shape),
        "n_nonfinite": int((~finite).sum()),
        "min": float(fa.min()) if fa.size else None,
        "max": float(fa.max()) if fa.size else None,
        "mean": float(fa.mean()) if fa.size else None,
        "std": float(fa.std()) if fa.size else None,
    }


def _write_nan_diagnostics(output_dir: Path, result: FitResult,
                           setup: ExperimentSetup,
                           nan_epochs: np.ndarray) -> None:
    """Postmortem after NaN-poisoned epochs, keyed as the JAX package keys
    it (experiment.py:394-431): the poisoned epochs, the tails of the loss
    histories, per-tensor statistics of the serving and final-EMA params
    and of the training inputs."""
    flat_params: Dict[str, Any] = {}

    def walk(tree, prefix, into):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.", into)
        else:
            into[prefix[:-1]] = _tensor_stats(np.asarray(tree))

    walk(result.params, "serving_params.", flat_params)
    if result.final_ema is not None:
        walk(result.final_ema, "final_ema.", flat_params)
    diag = {
        "nan_epochs": nan_epochs.tolist(),
        "n_epochs_run": int(result.n_epochs_run),
        "train_loss_tail": np.asarray(
            result.history["train_loss"])[-10:].tolist(),
        "val_loss_tail": np.asarray(
            result.history["val_loss"])[-10:].tolist(),
        "inputs": {
            "train_y": _tensor_stats(setup.train_ps.y),
            "train_coords": _tensor_stats(setup.train_ps.coords),
            "train_t": _tensor_stats(setup.train_ps.t),
        },
        "params": flat_params,
    }
    save_json(diag, output_dir / "nan_diagnostics.json")
