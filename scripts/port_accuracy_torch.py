#!/usr/bin/env python
"""Full-length N-seed accuracy table of the PyTorch/CUDA port on one GPU:
the port's side of `results/port_accuracy/`, twin of
`scripts/port_accuracy_jax.py`.

    python3 scripts/port_accuracy_torch.py --engine vmap \
        --output_dir build/port_accuracy/torch_vmap [--n 10]
    python3 scripts/port_accuracy_torch.py --engine sequential \
        --output_dir build/port_accuracy/torch_sequential --skip_existing

Runs `st_dadk_tpu_torch.train.runner.run_multiple_experiments` on the bench
workload (500-epoch cap, patience 50) for seeds base_seed + 0..n-1, on the
stand-in field `data/standin/2a_8_standin-<hash>.csv` unless `--data_file`
names another CSV. Each side uses its own init and RNG streams, so the two
packages agree in distribution, not seed by seed. `--skip_existing` resumes
a run that was cut. `--first N --last M` runs experiments N..M only, so
that several processes can share one card (each with its own
`--run_info`), and a last `--skip_existing` run over all n aggregates.
`run_info.json` records the card's name and power limit beside the wall
time. The model and prediction files are not written
(`save_artifacts: false`): the scores and histories are in `results.json`.

    python3 scripts/port_accuracy_torch.py --table44 --engine vmap \
        --output_dir build/port_accuracy/table_4_4_torch [--n 10]

Table 4.4 instead: the port's `st_dadk_tpu_torch.cli.run_table_4_4` on
configs/config_st_interp.yaml, n seeds a cell, with the same overrides
(`save_artifacts: false`), and its `run_info.json`.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--output_dir", type=Path, required=True)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--engine", default="vmap",
                    choices=["vmap", "sequential"])
    ap.add_argument("--data_file", type=Path, default=None)
    ap.add_argument("--epochs", type=int, default=None,
                    help="cut the 500-epoch cap (for a rehearsal)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--skip_existing", action="store_true")
    ap.add_argument("--first", type=int, default=None,
                    help="the first experiment id to run (default 1)")
    ap.add_argument("--last", type=int, default=None,
                    help="the last experiment id to run (default n)")
    ap.add_argument("--run_info", default="run_info.json",
                    help="the file name of the run's record in "
                    "--output_dir")
    ap.add_argument("--table44", action="store_true",
                    help="run Table 4.4 through the port's CLI")
    args = ap.parse_args(argv)

    import torch

    from st_dadk_tpu_torch.bench_workload import bench_workload
    from st_dadk_tpu_torch.dataio.synthetic import bench_data_file
    from st_dadk_tpu_torch.train.runner import run_multiple_experiments

    if args.device == "cuda" and not torch.cuda.is_available():
        print("port_accuracy_torch: no CUDA device", file=sys.stderr)
        return 2
    card = "CPU host"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    data_file = args.data_file or bench_data_file()
    if args.table44:
        from st_dadk_tpu_torch.cli import run_table_4_4
        extra = {"save_artifacts": False}
        if args.epochs is not None:
            extra["epochs"] = args.epochs
        if args.device != "cuda":
            extra["device"] = args.device
        t0 = time.time()
        run_table_4_4.main(
            ["--config", str(REPO / "configs" / "config_st_interp.yaml"),
             "--data_file", str(data_file), "--n_experiments", str(args.n),
             "--engine", args.engine, "--overrides", json.dumps(extra),
             "--output_dir", str(args.output_dir)]
            + (["--skip-existing"] if args.skip_existing else []))
        info = {"framework": "torch", "torch": torch.__version__,
                "engine": args.engine, "n": args.n, "table": "4.4",
                "data_file": Path(data_file).name,
                "wall_seconds": time.time() - t0,
                "resumed": bool(args.skip_existing), "hardware": card}
        (args.output_dir / "run_info.json").write_text(
            json.dumps(info, indent=1))
        print(f"wall {info['wall_seconds']:.1f} s on {card}", flush=True)
        return 0
    overrides = dict(data_file=str(data_file), n_experiments=args.n,
                     tag="port_accuracy_torch", save_artifacts=False)
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    cfg = bench_workload(**overrides)
    print(f"card {card}  data {data_file}  engine {args.engine}  n {args.n}",
          flush=True)
    t0 = time.time()
    summary = run_multiple_experiments(cfg, args.output_dir,
                                       skip_existing=args.skip_existing,
                                       verbose=True, engine=args.engine,
                                       device=args.device,
                                       start_exp_id=args.first,
                                       end_exp_id=args.last)
    wall = time.time() - t0
    info = {"framework": "torch", "torch": torch.__version__,
            "engine": args.engine, "n": args.n,
            "experiments": [args.first or 1, args.last or args.n],
            "data_file": Path(data_file).name, "wall_seconds": wall,
            "resumed": bool(args.skip_existing), "hardware": card}
    (args.output_dir / args.run_info).write_text(json.dumps(info, indent=1))
    if summary is None:
        print("no results", file=sys.stderr)
        return 1
    for m in ("test_rmse", "test_crps"):
        s = summary["statistics"][m]
        print(f"{m}: mean {s['mean']!r} std {s['std']!r} n {len(s['values'])}")
    print(f"wall {wall:.1f} s on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
