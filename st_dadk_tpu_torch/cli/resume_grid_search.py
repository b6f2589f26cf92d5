"""Resume or repair a grid-search run (port of
`scripts/resume_grid_search.py`).

    python3 -m st_dadk_tpu_torch.cli.resume_grid_search RESULTS_DIR \
        [--start_exp_id A] [--end_exp_id B] [--skip-existing] \
        [--summarize-only] [--engine vmap|sequential]

Finds the config directories (a `config.yaml` beside an `experiments/`
tree), re-runs an experiment-id range of each through the runner
(optionally skipping the ones with a `results.json`), then rebuilds every
config's summary and the grid-level CSVs from what is on disk. The fits run
on each config's `device` (`tpu` and `gpu` mean the card).
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, List, Optional

from st_dadk_tpu_torch.config import ExperimentConfig, read_yaml
from st_dadk_tpu_torch.sweep.grid import save_experiment_results
from st_dadk_tpu_torch.train.runner import (aggregate_results,
                                            load_all_results,
                                            run_multiple_experiments)


def discover_config_dirs(results_dir: Path) -> List[Path]:
    """The directories holding a config.yaml and an experiments/ tree."""
    return [f.parent for f in sorted(results_dir.glob("**/config.yaml"))
            if (f.parent / "experiments").exists()]


def regenerate(results_dir: Path) -> List[Dict[str, Any]]:
    """Re-aggregate every config from its results.json files and rewrite the
    grid-level CSVs. A config without `config_id` gets one above every
    existing id, so that no two configs share one."""
    loaded = []
    for cdir in discover_config_dirs(results_dir):
        config = read_yaml(cdir / "config.yaml")
        results = load_all_results(cdir / "experiments",
                                   config.get("n_experiments", 10))
        summary = (aggregate_results(results, cdir / "summary")
                   if results else None)
        loaded.append((config, summary))
    next_id = max((c.get("config_id", 0) for c, _ in loaded), default=0) + 1
    all_results = []
    for config, summary in loaded:
        if "config_id" not in config:
            config["config_id"] = next_id
            next_id += 1
        all_results.append({"config": config, "summary": summary,
                            "status": "success" if summary else "empty"})
    if all_results:
        save_experiment_results(all_results, results_dir)
        print(f"[OK] regenerated grid CSVs for {len(all_results)} configs")
    return all_results


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("results_dir", type=str)
    parser.add_argument("--start_exp_id", type=int, default=None)
    parser.add_argument("--end_exp_id", type=int, default=None)
    parser.add_argument("--skip-existing", action="store_true")
    parser.add_argument("--summarize-only", action="store_true")
    parser.add_argument("--engine", type=str, default="vmap",
                        choices=["vmap", "sequential"])
    return parser


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    args = build_parser().parse_args(argv)
    results_dir = Path(args.results_dir)
    if not results_dir.exists():
        raise SystemExit(f"not found: {results_dir}")
    if not args.summarize_only:
        for cdir in discover_config_dirs(results_dir):
            config = read_yaml(cdir / "config.yaml")
            print(f"\n=== resuming {cdir.name} ===")
            run_multiple_experiments(
                ExperimentConfig.from_dict(config), cdir,
                start_exp_id=args.start_exp_id, end_exp_id=args.end_exp_id,
                skip_existing=args.skip_existing, engine=args.engine)
    return regenerate(results_dir)


if __name__ == "__main__":
    main()
