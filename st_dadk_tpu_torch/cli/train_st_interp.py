"""Multi-experiment training CLI (port of `scripts/train_st_interp.py`).

    python3 -m st_dadk_tpu_torch.cli.train_st_interp \
        --config configs/config_st_interp.yaml [--data_file F] \
        [--n_experiments N] [--base_seed S] [--start_exp_id A] \
        [--end_exp_id B] [--skip-existing] [--engine sequential|vmap]

Output tree: results/<YYYYMMDD>/<HHMMSS>_<tag>/{config.yaml, experiments/<i>/,
summary/}, the timestamp in local time. `--parallel` means `--engine vmap`
(all repeats as lanes of one batched program on the card); `--n_jobs` is
accepted and ignored. The fits run on the config's `device` (`tpu` and
`gpu` mean the card).

Several processes (`parallel/multihost.py`): the CLI joins a process group
when torchrun's (or JAX's) environment names one, and every process takes
one output tree from the primary's clock:

    torchrun --nproc_per_node N -m st_dadk_tpu_torch.cli.train_st_interp \
        --config C --engine dp          # each fit data-parallel over N cards
    torchrun --nproc_per_node N -m st_dadk_tpu_torch.cli.train_st_interp \
        --config C --engine vmap        # each process trains its lanes

Rank r runs on card LOCAL_RANK (modulo the cards it sees) over nccl, which
wants a card a rank; a config with `device: cpu` runs over gloo. The flags
are the JAX script's.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, List, Optional

from st_dadk_tpu_torch.config import load_config, resolve_device
from st_dadk_tpu_torch.parallel.multihost import (
    is_primary, maybe_initialize_distributed, shared_timestamp)
from st_dadk_tpu_torch.train.runner import run_multiple_experiments


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str,
                        default="configs/config_st_interp.yaml")
    parser.add_argument("--data_file", type=str, default=None)
    parser.add_argument("--n_experiments", type=int, default=None)
    parser.add_argument("--base_seed", type=int, default=None)
    parser.add_argument("--parallel", action="store_true",
                        help="compat flag; maps to --engine vmap")
    parser.add_argument("--n_jobs", type=int, default=-1,
                        help="compat flag (ignored)")
    parser.add_argument("--engine", type=str, default=None,
                        choices=["sequential", "vmap", "dp"],
                        help="experiment dispatch engine: sequential fits, "
                             "all repeats as lanes of one batched program, "
                             "or per-fit data parallelism over every "
                             "process of the group")
    parser.add_argument("--start_exp_id", type=int, default=None)
    parser.add_argument("--end_exp_id", type=int, default=None)
    parser.add_argument("--skip-existing", action="store_true")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--verbose", action="store_true")
    return parser


def main(argv: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config, {
        "data_file": args.data_file,
        "n_experiments": args.n_experiments,
        "base_seed": args.base_seed,
    })
    engine = args.engine or ("vmap" if args.parallel else "sequential")
    # one process a card under torchrun; a no-op for a single process
    maybe_initialize_distributed(device=resolve_device(cfg.device).type)

    now = shared_timestamp()
    if args.output_dir:
        base_output_dir = Path(args.output_dir)
    else:
        base_output_dir = (Path("results") / now.strftime("%Y%m%d")
                           / f"{now.strftime('%H%M%S')}_{cfg.tag}")
    base_output_dir.mkdir(parents=True, exist_ok=True)
    if is_primary():
        cfg.to_yaml(base_output_dir / "config.yaml")

    print("=" * 70)
    print("MULTIPLE EXPERIMENT RUNNER (CUDA)")
    print(f"tag={cfg.tag}  n_experiments={cfg.n_experiments}  "
          f"base_seed={cfg.base_seed}  engine={engine}")
    print(f"output: {base_output_dir}")
    print("=" * 70, flush=True)

    summary = run_multiple_experiments(
        cfg, base_output_dir,
        start_exp_id=args.start_exp_id, end_exp_id=args.end_exp_id,
        skip_existing=args.skip_existing, verbose=args.verbose,
        engine=engine)

    if summary:
        print("\nSUMMARY (test):")
        for m in ("test_rmse", "test_mae", "test_crps", "total_time_seconds"):
            st = summary["statistics"].get(m)
            if st:
                print(f"  {m:<20} mean={st['mean']:.6f} std={st['std']:.6f}")
    return summary


if __name__ == "__main__":
    main()
