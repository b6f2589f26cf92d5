#!/usr/bin/env python
"""Full-length N-seed accuracy table of the JAX package on the CPU: the
reference side of `results/port_accuracy/`.

    JAX_PLATFORMS=cpu python scripts/port_accuracy_jax.py \
        --output_dir build/port_accuracy/jax_vmap [--n 10] [--engine vmap]

Runs `st_dadk_tpu.train.runner.run_multiple_experiments` on the bench
workload (500-epoch cap, patience 50) for seeds base_seed + 0..n-1, on the
stand-in field `data/standin/2a_8_standin-<hash>.csv` unless `--data_file`
names another CSV. The PyTorch twin, `scripts/port_accuracy_torch.py`,
runs the port's runner on the same CSV on a GPU; each side uses its own
init and RNG. `scripts/port_accuracy_compare.py` reads both summaries.

XLA on the CPU compiles the full-width lane program for many minutes
before the first epoch. `--skip_existing` resumes a run that was cut.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def standin_csv() -> Path:
    """The stand-in field's path, written on first use. The generator is
    the port's numpy module, loaded by file so that neither torch nor the
    port's package is imported here."""
    import importlib.util
    src = REPO / "st_dadk_tpu_torch" / "dataio" / "synthetic.py"
    spec = importlib.util.spec_from_file_location("_standin_synthetic", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # the module finds the repo root from its own path
    return mod.bench_data_file()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--output_dir", type=Path, required=True)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--engine", default="vmap",
                    choices=["vmap", "sequential"])
    ap.add_argument("--data_file", type=Path, default=None)
    ap.add_argument("--epochs", type=int, default=None,
                    help="cut the 500-epoch cap (for a rehearsal)")
    ap.add_argument("--skip_existing", action="store_true")
    args = ap.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from st_dadk_tpu.utils.platform import apply_platform_env
    apply_platform_env()
    import jax
    from st_dadk_tpu.bench_workload import bench_workload
    from st_dadk_tpu.train.runner import run_multiple_experiments

    data_file = args.data_file or standin_csv()
    overrides = dict(data_file=str(data_file), n_experiments=args.n,
                     tag="port_accuracy_jax")
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    cfg = bench_workload(**overrides)
    print(f"backend {jax.default_backend()}  data {data_file}  "
          f"engine {args.engine}  n {args.n}", flush=True)
    t0 = time.time()
    summary = run_multiple_experiments(cfg, args.output_dir,
                                       skip_existing=args.skip_existing,
                                       verbose=True, engine=args.engine)
    wall = time.time() - t0
    info = {"framework": "jax", "backend": jax.default_backend(),
            "engine": args.engine, "n": args.n, "data_file": data_file.name,
            "wall_seconds": wall, "hardware": "CPU host"}
    (args.output_dir / "run_info.json").write_text(json.dumps(info, indent=1))
    if summary is None:
        print("no results", file=sys.stderr)
        return 1
    for m in ("test_rmse", "test_crps"):
        s = summary["statistics"][m]
        print(f"{m}: mean {s['mean']!r} std {s['std']!r} n {len(s['values'])}")
    print(f"wall {wall:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
