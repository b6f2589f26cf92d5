"""Grid-search engine: config generation, execution and the CSV contract
(port of `st_dadk_tpu/sweep/grid.py`).

  - the cartesian product of a parameter grid over a base config, with an
    optional filter and the same abbreviated tags;
  - a directory a config with its `config.yaml` (the port's YAML writer);
  - `grid_search_summary.csv`, `grid_search_detail.csv` and
    `grid_search_configs.{json,csv}` with the JAX package's columns and
    rows, written with the `csv` module where it uses pandas.

Engine 'vmap' buckets the configs by `stacking_key` and dataset shape, and
every bucket's configs x repeats run as lanes through `run_lane_jobs`;
configs that differ only in `k_spatial_centers` get one `k_spatial_pad`
and run as ragged lanes. 'sequential' runs the configs one after the other
through the runner. With a process group joined (`parallel/multihost.py`,
JAX `:208`, `:286-288`) every process runs its own lanes (or its stripe of
fits) and writes their artifacts; after a barrier only the primary writes
the config files, aggregates and writes the summaries, and the other
processes return an empty list.
"""
from __future__ import annotations

import csv
import itertools
import json
import math
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from st_dadk_tpu_torch.config import ExperimentConfig, write_yaml
from st_dadk_tpu_torch.parallel.multihost import is_primary, sync_processes
from st_dadk_tpu_torch.train.runner import (aggregate_results,
                                            load_all_results,
                                            run_multiple_experiments)

_TAG_ABBREV = {
    "spatial_basis_function": {"wendland": "wend", "gaussian": "gaus",
                               "triangular": "tria"},
    "spatial_init_method": {"uniform": "uni", "gmm": "gmm",
                            "random_site": "rnd", "kmeans_balanced": "kmb",
                            "kmeans_exact": "kme"},
}


def _tag_part(param_name: str, param_value: Any) -> str:
    if param_name == "data_file":
        # the tag becomes a directory name: the file's stem, never a path
        return Path(str(param_value)).stem
    if param_name in _TAG_ABBREV:
        return _TAG_ABBREV[param_name].get(param_value, str(param_value))
    if param_name == "spatial_learnable":
        return "lrn" if param_value else "fix"
    if param_name == "obs_method":
        return "site" if param_value == "site-wise" else "rand"
    if param_name == "obs_ratio":
        # int() truncation is the reference's, binary-float off-by-one
        # included (0.29 * 100 -> '28'), so that directories match
        return f"{int(param_value * 100)}"
    if param_name == "obs_spatial_pattern":
        return "cor" if param_value == "corner" else "unf"
    return str(param_value)


def generate_config_combinations(
    base_config: Dict[str, Any],
    param_grid: Dict[str, List[Any]],
    filter_fn: Optional[Callable[[Dict[str, Any]], bool]] = None,
) -> List[Dict[str, Any]]:
    """Cartesian product of param_grid over base_config, filtered, with
    abbreviated tags `configNNN_<parts>` numbered over kept configs only."""
    param_names = list(param_grid.keys())
    configs = []
    counter = 0
    for combo in itertools.product(*param_grid.values()):
        param_dict = dict(zip(param_names, combo))
        if filter_fn is not None and not filter_fn(param_dict):
            continue
        counter += 1
        config = dict(base_config)
        config.update(param_dict)
        tag_parts = [f"config{counter:03d}"]
        tag_parts += [_tag_part(n, v) for n, v in zip(param_names, combo)]
        config["tag"] = "_".join(tag_parts)
        config["config_id"] = counter
        configs.append(config)
    return configs


_SUMMARY_METRICS = ["test_rmse", "test_mae", "test_mse",
                    "valid_rmse", "valid_mae", "valid_mse",
                    "train_rmse", "train_mae", "train_mse",
                    "test_crps", "valid_crps", "train_crps",
                    "test_check_loss", "valid_check_loss", "train_check_loss",
                    "total_time_seconds"]
_CONFIG_COLS = ["spatial_basis_function", "spatial_init_method",
                "spatial_learnable", "obs_method", "obs_ratio",
                "obs_spatial_pattern"]


def _is_number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def write_records(records: List[Dict[str, Any]], path: Path) -> None:
    """`pd.DataFrame(records).to_csv(path, index=False)` without pandas:
    the columns in order of first appearance, a missing cell empty, and
    each column written as the data frame's dtype writes it (a number
    column holding a float or a gap is float64, its whole numbers with
    '.0' and a NaN empty; a column of numbers only is int64; anything else
    is objects)."""
    columns: List[str] = []
    for r in records:
        columns += [c for c in r if c not in columns]
    cells = {c: [r.get(c) for r in records] for c in columns}
    with open(path, "w", newline="", encoding="utf-8") as f:
        wr = csv.writer(f)
        if not columns:
            f.write("\n")
            return
        wr.writerow(columns)
        fmt = {}
        for c, vals in cells.items():
            present = [v for v in vals if v is not None]
            if present and all(_is_number(v) for v in present) and (
                    len(present) < len(vals)
                    or any(isinstance(v, float) for v in present)):
                fmt[c] = lambda v: ("" if v is None or math.isnan(v)
                                    else repr(float(v)))
            else:
                fmt[c] = lambda v: "" if v is None else str(v)
        for i in range(len(records)):
            wr.writerow([fmt[c](cells[c][i]) for c in columns])


def save_experiment_results(all_results: List[Optional[Dict[str, Any]]],
                            output_dir: Path):
    """Write the grid-level CSV and JSON files: (summary records, detail
    records), the rows of the two CSVs."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    summary_records = []
    detail_records: Dict[tuple, Dict[str, Any]] = {}
    config_records, configs_dict = [], {}

    for result in all_results:
        if result is None:
            continue
        config = result["config"]
        config_records.append({"config_id": config["config_id"],
                               "tag": config["tag"]})
        configs_dict[str(config["config_id"])] = config
        summary = result.get("summary")
        if summary is None:
            continue

        record = {"config_id": config["config_id"], "tag": config["tag"]}
        for c in _CONFIG_COLS:
            record[c] = config.get(c)
        record["n_experiments"] = summary["n_experiments"]
        for metric in _SUMMARY_METRICS:
            if metric in summary["statistics"]:
                stats = summary["statistics"][metric]
                for s in ("mean", "std", "min", "max", "median"):
                    record[f"{metric}_{s}"] = stats[s]
        summary_records.append(record)

        for metric in _SUMMARY_METRICS:
            if metric not in summary["statistics"]:
                continue
            # enumerate(values, 1) relabels rows when a repeat is missing
            # (a gap shifts later ids): the reference's schema, kept
            for exp_id, value in enumerate(
                    summary["statistics"][metric]["values"], 1):
                key = (config["config_id"], exp_id)
                if key not in detail_records:
                    rec = {"config_id": config["config_id"],
                           "tag": config["tag"], "experiment_id": exp_id}
                    for c in _CONFIG_COLS:
                        rec[c] = config.get(c)
                    detail_records[key] = rec
                detail_records[key][metric] = value

    details = list(detail_records.values())
    write_records(summary_records, output_dir / "grid_search_summary.csv")
    write_records(details, output_dir / "grid_search_detail.csv")
    with open(output_dir / "grid_search_configs.json", "w",
              encoding="utf-8") as f:
        json.dump(configs_dict, f, indent=2, ensure_ascii=False, default=str)
    write_records(config_records, output_dir / "grid_search_configs.csv")
    return summary_records, details


def run_grid_search(
    base_config: Dict[str, Any],
    param_grid: Dict[str, List[Any]],
    output_dir: Path,
    filter_fn: Optional[Callable[[Dict[str, Any]], bool]] = None,
    engine: str = "vmap",
    skip_existing: bool = False,
    verbose: bool = False,
    device: Optional[torch.device | str] = None,
) -> List[Dict[str, Any]]:
    """Run the whole grid on `device` (default: each config's). engine
    'vmap': the configs x repeats of a bucket (one stacking key and dataset
    shape) run as lanes; 'sequential': a config at a time, a fit at a
    time. One {"config", "summary", "status"} dict a config."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    configs = generate_config_combinations(base_config, param_grid, filter_fn)
    for config in configs:
        config_dir = output_dir / config["tag"]
        config_dir.mkdir(parents=True, exist_ok=True)
        if is_primary():
            write_yaml(config, config_dir / "config.yaml")

    if engine == "vmap":
        all_results = _run_grid_stacked(configs, output_dir,
                                        skip_existing=skip_existing,
                                        verbose=verbose, device=device)
    else:
        all_results = []
        for i, config in enumerate(configs, 1):
            print(f"[{i}/{len(configs)}] {config['tag']}", flush=True)
            try:
                summary = run_multiple_experiments(
                    ExperimentConfig.from_dict(config),
                    output_dir / config["tag"], skip_existing=skip_existing,
                    verbose=verbose, engine=engine, device=device)
                all_results.append({"config": config, "summary": summary,
                                    "status": "success"})
            except Exception as e:
                traceback.print_exc()
                all_results.append({"config": config, "summary": None,
                                    "status": "failed", "error": str(e)})
    if not is_primary():
        return []
    save_experiment_results(all_results, output_dir)
    return all_results


def ragged_pads(cfg_objs: List[ExperimentConfig]) -> List[ExperimentConfig]:
    """Configs whose stacking keys differ only in `k_spatial_centers` (and
    set no `k_spatial_pad` of their own) get k_spatial_pad = their group's
    widest total k, so that they run as ragged lanes of one program."""
    from st_dadk_tpu_torch.train.batch_engine import stacking_key

    out = list(cfg_objs)
    groups: Dict[Any, List[int]] = {}
    for i, c in enumerate(out):
        groups.setdefault(stacking_key(c.replace(k_spatial_pad=-1)),
                          []).append(i)
    for members in groups.values():
        klists = {tuple(out[i].k_spatial_centers) for i in members}
        if len(klists) > 1 and all(out[i].k_spatial_pad is None
                                   for i in members):
            k_pad = max(sum(k) for k in klists)
            for i in members:
                out[i] = out[i].replace(k_spatial_pad=k_pad)
    return out


def grid_buckets(cfg_objs: List[ExperimentConfig], tags: List[str]
                 ) -> Dict[Any, List[int]]:
    """Config indices by (stacking key, dataset shape); a file that cannot
    be read is a bucket of its own, where its fit reports the error."""
    from st_dadk_tpu_torch.train.batch_engine import stacking_key
    from st_dadk_tpu_torch.train.experiment import _load_cached

    buckets: Dict[Any, List[int]] = {}
    for i, c in enumerate(cfg_objs):
        try:
            z, _, _ = _load_cached(c.resolve_data_file(), c.normalize_target,
                                   False)
            shape = z.shape
        except Exception:
            shape = ("unknown", tags[i])
        buckets.setdefault((stacking_key(c), shape), []).append(i)
    return buckets


def _run_grid_stacked(configs: List[Dict[str, Any]], output_dir: Path,
                      skip_existing: bool, verbose: bool,
                      device: Optional[torch.device | str] = None
                      ) -> List[Dict[str, Any]]:
    """One lane batch (or stream of batches) a bucket, then each config's
    aggregation into its own summary."""
    from st_dadk_tpu_torch.train.batch_engine import (aggregate_per_tau,
                                                      expand_per_tau_jobs,
                                                      is_per_tau,
                                                      run_lane_jobs)

    cfg_objs = ragged_pads([ExperimentConfig.from_dict(c) for c in configs])
    buckets = grid_buckets(cfg_objs, [c["tag"] for c in configs])
    failed: Dict[int, str] = {}
    per_tau: List[int] = []
    for b_idx, members in enumerate(buckets.values(), 1):
        jobs = []
        for i in members:
            exp_dir = output_dir / configs[i]["tag"] / "experiments"
            c = cfg_objs[i]
            ids = list(range(1, c.n_experiments + 1))
            if is_per_tau(c):
                jobs.extend(expand_per_tau_jobs(c, ids, exp_dir))
                per_tau.append(i)
            else:
                jobs.extend((c, e, exp_dir / str(e)) for e in ids)
        print(f"[bucket {b_idx}/{len(buckets)}] {len(members)} configs x "
              f"{cfg_objs[members[0]].n_experiments} repeats = "
              f"{len(jobs)} lanes", flush=True)
        try:
            run_lane_jobs(jobs, cfg_objs[members[0]],
                          skip_existing=skip_existing, verbose=verbose,
                          device=device)
        except Exception as e:
            traceback.print_exc()
            for i in members:
                failed[i] = str(e)

    # every process wrote its own lanes; the primary aggregates them all
    sync_processes("st_dadk_grid_aggregate")
    if not is_primary():
        return []
    for i in per_tau:
        if i in failed:
            continue
        try:
            aggregate_per_tau(cfg_objs[i],
                              list(range(1, cfg_objs[i].n_experiments + 1)),
                              output_dir / configs[i]["tag"] / "experiments",
                              skip_existing=skip_existing)
        except Exception as err:
            failed[i] = str(err)

    all_results = []
    for i, config in enumerate(configs):
        config_dir = output_dir / config["tag"]
        if i in failed:
            all_results.append({"config": config, "summary": None,
                                "status": "failed", "error": failed[i]})
            continue
        results = load_all_results(config_dir / "experiments",
                                   cfg_objs[i].n_experiments)
        summary = (aggregate_results(results, config_dir / "summary")
                   if results else None)
        all_results.append({"config": config, "summary": summary,
                            "status": "success" if summary else "failed"})
    return all_results
