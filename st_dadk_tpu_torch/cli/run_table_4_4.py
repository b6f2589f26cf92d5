"""Table 4.4: STDK against DA-STDK, test CRPS in four observation scenarios
(port of `scripts/run_table_4_4.py`).

    python3 -m st_dadk_tpu_torch.cli.run_table_4_4 \
        [--config configs/config_st_interp.yaml] [--data_file F] \
        [--n_experiments 10] [--engine vmap|sequential] [--skip-existing] \
        [--overrides JSON] [--delta_penalty_mode abs|eq310]

Protocol: dataset 2b_8 where its file exists, else 2a_8 (or `--data_file`),
multi-quantile tau = {.05, .25, .5, .75, .95} with the delta head,
obs_ratio 0.1, non_crossing_lambda 1.0 unless the config or the flag names
one; scenarios {Fixed, Random} x {Uniform, Clustered}; models STDK (uniform
grid, fixed) and DA-STDK (balanced k-means, learnable). Each of the 8
(scenario, model) cells runs its repeats through the runner; the output
tree holds a directory a cell with its `config.yaml` and
`scenario_summary.json`, and `table_4_4_summary.json`.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from st_dadk_tpu_torch.config import ExperimentConfig, write_yaml
from st_dadk_tpu_torch.parallel.multihost import (
    is_primary, maybe_initialize_distributed, shared_timestamp)
from st_dadk_tpu_torch.train.runner import (load_all_results,
                                            run_multiple_experiments)
from st_dadk_tpu_torch.utils.io import save_json

SCENARIOS = [
    {"name": "Fixed_Uniform", "obs_method": "site-wise",
     "obs_spatial_pattern": "uniform"},
    {"name": "Fixed_Clustered", "obs_method": "site-wise",
     "obs_spatial_pattern": "corner"},
    {"name": "Random_Uniform", "obs_method": "random",
     "obs_spatial_pattern": "uniform"},
    {"name": "Random_Clustered", "obs_method": "random",
     "obs_spatial_pattern": "corner"},
]

MODELS = [
    {"name": "STDK", "spatial_init_method": "uniform",
     "spatial_learnable": False},
    {"name": "DA-STDK", "spatial_init_method": "kmeans_balanced",
     "spatial_learnable": True},
]

EQ310_WARNING = (
    "eq310 mode reproduces the reference's sign-convention bug "
    "(train_st_interp.py:100-110): the P_nc(delta) penalty REWARDS "
    "quantile crossing, the loss runs away to -inf, and the "
    "resulting CRPS values are noise. These results document "
    "protocol fidelity only and must not be read as model quality; "
    "use the default 'abs' mode for meaningful tables.")


def create_table_4_4_configs(base_config_path, da_stdk_init_method=None,
                             non_crossing_lambda=None, data_file=None,
                             delta_penalty_mode="abs"
                             ) -> List[Tuple[str, str, Dict[str, Any]]]:
    """(scenario, model, config dict) for the 8 cells. 'abs' penalises
    non-crossing infeasibility; 'eq310' is the reference's literal sign
    convention, quarantined (see `main`)."""
    base = ExperimentConfig.from_yaml(base_config_path).to_dict()
    base["regression_type"] = "multi-quantile"
    base["quantile_levels"] = [0.05, 0.25, 0.5, 0.75, 0.95]
    base["obs_ratio"] = 0.1
    base["use_delta_reparameterization"] = True
    base["non_crossing_lambda"] = (non_crossing_lambda
                                   if non_crossing_lambda is not None
                                   else base.get("non_crossing_lambda") or 1.0)
    base["non_crossing_delta_mode"] = delta_penalty_mode
    # the thesis uses 2b_8; without its file, 2a_8
    if data_file:
        base["data_file"] = data_file
    else:
        cand = ExperimentConfig.from_dict(
            {**base, "data_file": "data/2b/2b_8.csv"}).resolve_data_file()
        base["data_file"] = ("data/2b/2b_8.csv" if cand.exists()
                             else "data/2a/2a_8.csv")

    configs = []
    for scenario in SCENARIOS:
        for model in MODELS:
            cfg = dict(base)
            cfg["obs_method"] = scenario["obs_method"]
            cfg["obs_spatial_pattern"] = scenario["obs_spatial_pattern"]
            cfg["spatial_init_method"] = (
                da_stdk_init_method or model["spatial_init_method"]
                if model["name"] == "DA-STDK" else model["spatial_init_method"])
            cfg["spatial_learnable"] = model["spatial_learnable"]
            cfg["tag"] = f"table4.4_{scenario['name']}_{model['name']}"
            configs.append((scenario["name"], model["name"], cfg))
    return configs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/config_st_interp.yaml")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--n_experiments", type=int, default=10)
    parser.add_argument("--data_file", type=str, default=None)
    parser.add_argument("--da_stdk_init_method", type=str, default=None,
                        choices=[None, "kmeans_balanced", "kmeans_exact", "gmm",
                                 "random_site"])
    parser.add_argument("--non_crossing_lambda", type=float, default=None)
    parser.add_argument("--delta_penalty_mode", type=str, default="abs",
                        choices=["eq310", "abs"],
                        help="'abs' (default) penalizes non-crossing "
                             "infeasibility and is the headline protocol; "
                             "'eq310' reproduces the reference's literal "
                             "Eq. 3.10 sign convention, whose penalty "
                             "rewards infeasibility and runs away; its "
                             "tables are quarantined")
    parser.add_argument("--engine", type=str, default="vmap",
                        choices=["vmap", "sequential"])
    parser.add_argument("--skip-existing", action="store_true")
    parser.add_argument("--overrides", type=str, default="{}",
                        help="JSON config overrides merged into every "
                             "scenario/model config after the protocol "
                             "fields, e.g. "
                             "'{\"early_stop_min_rel_delta\": 0.001}'")
    return parser


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the table; returns the summary `table_4_4_summary.json` holds,
    with the output directory under '_output_dir'."""
    args = build_parser().parse_args(argv)
    overrides = json.loads(args.overrides)
    maybe_initialize_distributed()
    primary = is_primary()
    out = Path(args.output_dir or
               f"results/{shared_timestamp().strftime('%Y%m%d_%H%M%S')}"
               f"_table_4_4")
    out.mkdir(parents=True, exist_ok=True)

    if args.delta_penalty_mode == "eq310":
        print(f"[WARNING] {EQ310_WARNING}")
        if primary:
            (out / "QUARANTINE_eq310.txt").write_text(EQ310_WARNING + "\n")

    configs = create_table_4_4_configs(args.config, args.da_stdk_init_method,
                                       args.non_crossing_lambda,
                                       args.data_file,
                                       args.delta_penalty_mode)
    scenario_summaries: Dict[str, Any] = {}
    for scenario_name, model_name, cfg in configs:
        cfg.update(overrides)
        cfg["n_experiments"] = args.n_experiments
        cdir = out / cfg["tag"]
        cdir.mkdir(parents=True, exist_ok=True)
        if primary:
            write_yaml(cfg, cdir / "config.yaml")
        print(f"\n=== {scenario_name} / {model_name} "
              f"({args.n_experiments} repeats) ===", flush=True)
        run_multiple_experiments(ExperimentConfig.from_dict(cfg), cdir,
                                 skip_existing=args.skip_existing,
                                 engine=args.engine)
        if not primary:      # the primary summarises every process's fits
            continue
        results = load_all_results(cdir / "experiments", args.n_experiments)
        crps = [r["test_crps"] for r in results if "test_crps" in r]
        entry = {"scenario": scenario_name, "model": model_name,
                 "n": len(crps),
                 "test_crps_mean": float(np.mean(crps)) if crps else None,
                 "test_crps_std": float(np.std(crps)) if crps else None}
        scenario_summaries[f"{scenario_name}/{model_name}"] = entry
        save_json(entry, cdir / "scenario_summary.json")
        print(f"  test CRPS: {entry['test_crps_mean']:.4f} "
              f"+/- {entry['test_crps_std']:.4f}" if crps else
              "  (no results)", flush=True)

    if not primary:
        return {"_output_dir": str(out)}
    scenario_summaries["_protocol"] = {
        "delta_penalty_mode": args.delta_penalty_mode,
        "quarantined": args.delta_penalty_mode == "eq310",
        **({"overrides": overrides} if overrides else {})}
    save_json(scenario_summaries, out / "table_4_4_summary.json")
    print(f"\nTable 4.4 summary -> {out / 'table_4_4_summary.json'}")

    print(f"\n{'Scenario':<20} {'STDK':<20} {'DA-STDK':<20}")
    for s in SCENARIOS:
        row = [s["name"]]
        for m in MODELS:
            e = scenario_summaries.get(f"{s['name']}/{m['name']}")
            row.append(f"{e['test_crps_mean']:.4f}+/-{e['test_crps_std']:.4f}"
                       if e and e["test_crps_mean"] is not None else "-")
        print(f"{row[0]:<20} {row[1]:<20} {row[2]:<20}")
    return dict(scenario_summaries, _output_dir=str(out))


if __name__ == "__main__":
    main()
