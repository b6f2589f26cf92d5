"""Multi-experiment orchestration and aggregation (port of
`st_dadk_tpu/train/runner.py`).

`run_multiple_experiments` runs the repeats of one config, one fit after the
other (`engine="sequential"`) or as lanes of one batched program
(`engine="vmap"`, `train/batch_engine.py`), and aggregates every result on
disk. The filesystem contract is the JAX package's:

    <output_dir>/experiments/<i>/results.json
    <output_dir>/summary/summary_statistics.json
    <output_dir>/summary/all_experiments.csv

`all_experiments.csv` is written with the `csv` module (the JAX package uses
pandas): same columns, same order. The two summary figures
(`averaged_spatial_mse.png`, `observation_density.png`) are drawn from the
experiments' predictions.npz inside one try, as there: a figure never
fails the run.

With a process group joined (`parallel/multihost.py`), as in JAX
(`runner.py:138-199`): `engine="dp"` runs each fit data-parallel over
every rank and only the primary writes; the sequential engine stripes its
fits over the processes; the lane engine splits each batch's lanes over
them. After a barrier only the primary aggregates; the others return None.
"""
from __future__ import annotations

import csv
import json
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from st_dadk_tpu_torch.config import ExperimentConfig, resolve_device
from st_dadk_tpu_torch.parallel.data_parallel import DPGroup
from st_dadk_tpu_torch.parallel.multihost import (is_primary, local_device,
                                                  process_info,
                                                  sync_processes)
from st_dadk_tpu_torch.train.experiment import run_single_experiment
from st_dadk_tpu_torch.utils.io import save_json

AGG_METRICS = ["train_mse", "train_mae", "train_rmse",
               "valid_mse", "valid_mae", "valid_rmse",
               "test_mse", "test_mae", "test_rmse",
               "total_time_seconds"]
QUANTILE_METRICS = ["train_crps", "valid_crps", "test_crps",
                    "train_check_loss", "valid_check_loss", "test_check_loss"]
ENGINES = ("sequential", "vmap", "dp")


def aggregate_results(all_results: List[Dict[str, Any]], summary_dir: Path
                      ) -> Dict[str, Any]:
    """mean/std/min/max/median per metric over the given results; writes
    `summary_statistics.json` and `all_experiments.csv` into `summary_dir`."""
    summary_dir = Path(summary_dir)
    summary_dir.mkdir(parents=True, exist_ok=True)
    n = len(all_results)

    metrics_data: Dict[str, List[float]] = {m: [] for m in AGG_METRICS}
    for result in all_results:
        if "metrics" in result:
            for split in ("train", "valid", "test"):
                for m in ("mse", "mae", "rmse"):
                    metrics_data[f"{split}_{m}"].append(
                        result["metrics"][split][m])
        else:
            # the zero-fill on a missing metric is reference parity
            # (st_dadk_tpu/train/runner.py:50-58): a mixed-schema experiments
            # directory deflates the aggregate there too
            for key in AGG_METRICS:
                if key != "total_time_seconds":
                    metrics_data[key].append(result.get(key, 0))
        metrics_data["total_time_seconds"].append(
            result.get("total_time_seconds", 0.0))

    # quantile and multi-quantile extras when every result has them
    for m in QUANTILE_METRICS:
        vals = [r[m] for r in all_results if m in r]
        if len(vals) == n and n > 0:
            metrics_data[m] = vals

    summary: Dict[str, Any] = {"n_experiments": n, "statistics": {}}
    for name, values in metrics_data.items():
        arr = np.asarray(values, dtype=np.float64)
        if arr.size == 0:
            continue
        summary["statistics"][name] = {
            "mean": float(arr.mean()), "std": float(arr.std()),
            "min": float(arr.min()), "max": float(arr.max()),
            "median": float(np.median(arr)),
            "values": [float(v) for v in arr],
        }
    save_json(summary, summary_dir / "summary_statistics.json")

    # cross-experiment maps (JAX runner.py:82-93); figures only
    try:
        from st_dadk_tpu_torch.viz.plots import (
            create_averaged_spatial_mse, create_observation_density_map)
        exp_dirs = [Path(r["config"]["output_dir"]) for r in all_results
                    if isinstance(r.get("config"), dict)
                    and r["config"].get("output_dir")]
        if exp_dirs:
            create_averaged_spatial_mse(exp_dirs, summary_dir)
            create_observation_density_map(exp_dirs, summary_dir)
    except Exception as e:
        print(f"[WARNING] summary figures failed: {e}")

    columns: Dict[str, List[Any]] = {
        "experiment_id": [r.get("experiment_id", i + 1)
                          for i, r in enumerate(all_results)]}
    if all_results and "experiment_seed" in all_results[0]:
        columns["experiment_seed"] = [r["experiment_seed"]
                                      for r in all_results]
    for name, values in metrics_data.items():
        if len(values) == n:
            # a column that mixes a zero-filled 0 with floats is a float
            # column, as the data frame of the JAX package makes it
            mixed = any(isinstance(v, float) for v in values)
            columns[name] = [float(v) for v in values] if mixed else values
    with open(summary_dir / "all_experiments.csv", "w", newline="",
              encoding="utf-8") as f:
        wr = csv.writer(f)
        wr.writerow(list(columns))
        for row in zip(*columns.values()):
            wr.writerow(row)
    return summary


def load_all_results(experiments_dir: Path, n_experiments: int
                     ) -> List[Dict[str, Any]]:
    out = []
    for i in range(1, n_experiments + 1):
        f = Path(experiments_dir) / str(i) / "results.json"
        if f.exists():
            with open(f, "r", encoding="utf-8") as fh:
                out.append(json.load(fh))
    return out


def run_multiple_experiments(
    config: ExperimentConfig | Dict[str, Any],
    output_dir: Path,
    start_exp_id: Optional[int] = None,
    end_exp_id: Optional[int] = None,
    skip_existing: bool = False,
    verbose: bool = False,
    engine: str = "sequential",
    device: Optional[torch.device | str] = None,
) -> Optional[Dict[str, Any]]:
    """Run repeats [start, end] on `device` (default: the config's, the
    card; `config.resolve_device`) and aggregate everything on disk.

    engine='sequential' runs the fits one after the other; a fit that fails
    writes `error.txt` into its directory and the run goes on.
    engine='vmap' runs all repeats as lanes of one batched program
    (`train.batch_engine.run_experiment_batch`). engine='dp' runs the fits
    one after the other, each data-parallel over every rank of the joined
    group (one rank and no collective without a group), on the rank's
    device (`multihost.local_device`) unless `device` names one."""
    if engine not in ENGINES:
        raise ValueError(f"Unknown engine {engine!r}: expected "
                         "'sequential', 'vmap' or 'dp'")
    cfg = (config if isinstance(config, ExperimentConfig)
           else ExperimentConfig.from_dict(config))
    n_experiments = int(cfg.n_experiments)
    start_id = start_exp_id or 1
    end_id = end_exp_id or n_experiments
    device = resolve_device(device or local_device() or cfg.device)
    pc, pid = process_info()

    output_dir = Path(output_dir)
    experiments_dir = output_dir / "experiments"
    experiments_dir.mkdir(parents=True, exist_ok=True)

    if engine == "vmap":
        from st_dadk_tpu_torch.train.batch_engine import run_experiment_batch
        run_experiment_batch(cfg, list(range(start_id, end_id + 1)),
                             experiments_dir, skip_existing=skip_existing,
                             verbose=verbose, device=device)
    else:
        dp = DPGroup.default(device) if engine == "dp" else None
        write = dp is None or dp.primary
        for i in range(start_id, end_id + 1):
            if dp is None and pc > 1 and (i - start_id) % pc != pid:
                continue     # sequential fits stripe over the processes
            exp_dir = experiments_dir / str(i)
            exp_dir.mkdir(parents=True, exist_ok=True)
            try:
                run_single_experiment(cfg, i, exp_dir, device=device,
                                      verbose=verbose,
                                      skip_existing=skip_existing, dp=dp,
                                      write_artifacts=write)
            except Exception as e:   # the run goes on; the failure is on disk
                print(f"[FAILED] Experiment {i}: {e}")
                if write:
                    with open(exp_dir / "error.txt", "w",
                              encoding="utf-8") as f:
                        f.write(f"Experiment {i} FAILED\nError: {e}\n\n")
                        f.write(traceback.format_exc())

    # every process's writes land before the primary reads them back
    sync_processes("st_dadk_aggregate")
    if not is_primary():
        return None
    all_results = load_all_results(experiments_dir, n_experiments)
    if all_results:
        return aggregate_results(all_results, output_dir / "summary")
    return None
