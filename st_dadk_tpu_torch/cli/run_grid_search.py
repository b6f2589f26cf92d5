"""Grid-search CLI (port of `scripts/run_grid_search.py`).

    python3 -m st_dadk_tpu_torch.cli.run_grid_search \
        [--config configs/config_st_interp.yaml] [--engine vmap|sequential] \
        [--param_grid JSON] [--n_experiments N] [--skip-existing] [--dry-run]

`PARAM_GRID` and `config_filter` are the JAX script's: 6 data files x
wendland x {uniform+fixed, kmeans_balanced+learnable} x random obs 10%
corner. Engine 'vmap' runs each bucket of stackable configs x repeats as
lanes on the card (`sweep.grid.run_grid_search`). A run with a config
that succeeded ends with the analysis (`cli/analyze_grid_search.py`) of its
results directory, as the JAX script does; a failure of the analysis is
reported and does not fail the run.
"""
from __future__ import annotations

import argparse
import json
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

from st_dadk_tpu_torch.cli.analyze_grid_search import analyze
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.sweep.grid import (generate_config_combinations,
                                          run_grid_search)

PARAM_GRID = {
    "data_file": ["data/2a/2a_7.csv", "data/2a/2a_8.csv", "data/2a/2a_9.csv",
                  "data/2b/2b_7.csv", "data/2b/2b_8.csv", "data/2b/2b_9.csv"],
    "spatial_basis_function": ["wendland"],
    "spatial_init_method": ["uniform", "kmeans_balanced"],
    "spatial_learnable": [True, False],
    "obs_method": ["random"],
    "obs_ratio": [0.10],
    "obs_spatial_pattern": ["corner"],
}


def config_filter(params: Dict[str, Any]) -> bool:
    """uniform -> fixed only; data-adaptive inits -> learnable only."""
    if params["spatial_init_method"] == "uniform" and params["spatial_learnable"]:
        return False
    if params["spatial_init_method"] in ("gmm", "random_site",
                                         "kmeans_balanced") \
            and not params["spatial_learnable"]:
        return False
    return True


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Grid Search Runner (CUDA)")
    parser.add_argument("--config", type=str,
                        default="configs/config_st_interp.yaml")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--engine", type=str, default="vmap",
                        choices=["vmap", "sequential"])
    parser.add_argument("--parallel", action="store_true",
                        help="compat flag (vmap engine is the default)")
    parser.add_argument("--n_jobs", type=int, default=10,
                        help="compat flag (ignored)")
    parser.add_argument("--skip-existing", action="store_true")
    parser.add_argument("--param_grid", type=str, default=None,
                        help="JSON dict overriding the in-file PARAM_GRID")
    parser.add_argument("--n_experiments", type=int, default=None)
    parser.add_argument("--dry-run", dest="dry_run", action="store_true",
                        help="list the generated configs and exit without "
                             "running any fit")
    return parser


def main(argv: Optional[List[str]] = None
         ) -> Optional[List[Dict[str, Any]]]:
    args = build_parser().parse_args(argv)
    base_config = ExperimentConfig.from_yaml(args.config).to_dict()
    if args.n_experiments is not None:
        base_config["n_experiments"] = args.n_experiments
    param_grid = json.loads(args.param_grid) if args.param_grid else PARAM_GRID

    if args.output_dir is None:
        args.output_dir = (f"results/"
                           f"{datetime.now().strftime('%Y%m%d_%H%M%S')}"
                           f"_grid_search")
    output_dir = Path(args.output_dir)

    print("=" * 80)
    print("GRID SEARCH RUNNER (CUDA)")
    for k, v in param_grid.items():
        print(f"  {k}: {v}")
    print(f"  output: {output_dir}  engine: {args.engine}")
    print("=" * 80, flush=True)

    if args.dry_run:
        configs = generate_config_combinations(base_config, param_grid,
                                               config_filter)
        for i, c in enumerate(configs, 1):
            print(f"[{i:3d}] {c['tag']}")
        print(f"{len(configs)} configs (dry run; nothing executed)")
        return None

    results = run_grid_search(base_config, param_grid, output_dir,
                              filter_fn=config_filter, engine=args.engine,
                              skip_existing=args.skip_existing)
    n_ok = sum(1 for r in results if r["status"] == "success")
    print(f"\nGRID SEARCH COMPLETE: {n_ok}/{len(results)} configs succeeded")
    print(f"Results: {output_dir}")
    if n_ok > 0:
        try:
            analyze(output_dir)
        except Exception as e:  # the JAX script runs it with check=False
            print(f"[WARNING] grid analysis failed: {e!r}")
    return results


if __name__ == "__main__":
    main()
