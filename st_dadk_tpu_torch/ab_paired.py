"""Paired A/B of config overrides on the bench workload (port of the JAX
package's `scripts/ab_paired.py`).

    python3 -m st_dadk_tpu_torch.ab_paired --b train_dtype=bf16 \\
        [--a key=value ...] [--n_experiments 10] [--data_file F] \\
        [--arms a b] [--warmup_epochs E] [--out build/ab_bf16]

Fits the same seeds of `bench_workload` under a baseline arm `a` and a
modified arm `b` (the `--a` overrides, then `--b`'s on top), so that each
seed's CRPS delta is paired: same data, masks, init and streams wherever an
override does not touch them. This is the tool for knobs that perturb a
fit's arithmetic (`train_dtype=bf16`, `packed_optimizer=true`,
`tail_compaction=true`). Values parse by the port's YAML scalar rules
(`config.load_yaml`): `epochs=250` is an int, `lr=1.0e-3` a float,
`train_dtype=bf16` a string, `hidden_dims=[512, 512, 256]` a list.

Each arm first fits a warm-up run on seeds offset by 777000 (the
process's first launches, the kernels' first build and cuBLAS's
heuristics land there; `--warmup_epochs` cuts its epochs), then the timed
run through `run_multiple_experiments(engine="vmap")`. Every arm's wall
includes writing its results contract, so compare arms with each other.
Without `data/2a/2a_8.csv` the fit reads the stand-in field
(`dataio/synthetic.py`). Writes `<out>/ab_summary.json`: each arm's n, test
CRPS mean and std, test RMSE mean, cold (warm-up) and warm wall, and under
"paired" the per-seed CRPS and RMSE deltas b - a with `crps_delta_sigma`,
|mean delta| over its standard error. The card is required unless
`--device cpu` is passed (the tests).
"""
from __future__ import annotations

import argparse
import shutil
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from st_dadk_tpu_torch.bench_workload import bench_workload
from st_dadk_tpu_torch.config import ExperimentConfig, load_yaml
from st_dadk_tpu_torch.train.runner import (load_all_results,
                                            run_multiple_experiments)
from st_dadk_tpu_torch.utils.io import save_json
from st_dadk_tpu_torch.utils.timing import card_line

REPO = Path(__file__).resolve().parents[1]
WARMUP_SEED_OFFSET = 777000


def parse_overrides(pairs: Sequence[str]) -> Dict[str, Any]:
    """`key=value` pairs as a dict, each value read as a YAML scalar."""
    out: Dict[str, Any] = {}
    for p in pairs:
        k, sep, v = p.partition("=")
        if not sep or not k:
            raise SystemExit(f"override must be key=value, got: {p!r}")
        out[k] = load_yaml(f"{k}: {v}", source=f"--a/--b {p!r}")[k]
    return out


def arm_results(experiments_dir: Path, n: int) -> Dict[str, Dict[int, float]]:
    """{'crps': {experiment id: test CRPS}, 'rmse': {...}} of an arm."""
    results = load_all_results(experiments_dir, n)
    return {"crps": {r["experiment_id"]: r["test_crps"] for r in results
                     if "test_crps" in r},
            "rmse": {r["experiment_id"]: r["test_rmse"] for r in results
                     if "test_rmse" in r}}


def paired(a: Dict[str, Dict[int, float]],
           b: Dict[str, Dict[int, float]]) -> Dict[str, Any]:
    """The paired b - a deltas of the seeds both arms finished (JAX's
    `table['paired']`, with the per-seed deltas)."""
    common = sorted(set(a["crps"]) & set(b["crps"]))
    d = np.array([b["crps"][i] - a["crps"][i] for i in common])
    r = np.array([b["rmse"][i] - a["rmse"][i] for i in common])
    return {
        "n_pairs": len(common),
        "crps_delta_mean": float(d.mean()),
        "crps_delta_std": float(d.std()),
        "crps_delta_sigma": float(abs(d.mean()) / max(
            d.std() / np.sqrt(len(d)), 1e-12)),
        "rmse_delta_mean": float(r.mean()),
        "crps_deltas": {int(i): float(x) for i, x in zip(common, d)},
        "rmse_deltas": {int(i): float(x) for i, x in zip(common, r)},
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_experiments", type=int, default=16)
    ap.add_argument("--data_file", default=None)
    ap.add_argument("--a", nargs="*", default=[],
                    help="key=value overrides for the BASELINE arm")
    ap.add_argument("--b", nargs="+", required=True,
                    help="key=value overrides for the MODIFIED arm "
                         "(applied on top of the baseline arm's)")
    ap.add_argument("--out", default=str(REPO / "build" / "ab_paired"))
    ap.add_argument("--arms", nargs="+", default=["a", "b"],
                    help="the arms to (re)fit; the summary still takes "
                         "every completed arm found under --out")
    ap.add_argument("--warmup_epochs", type=int, default=None,
                    help="epochs of the warm-up runs (default: the arm's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("ab_paired: no CUDA device (pass --device cpu to run on the "
              "CPU)", file=sys.stderr)
        return 2
    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    data_file = args.data_file
    if data_file is None:
        from st_dadk_tpu_torch.dataio.synthetic import bench_data_file
        data_file = str(bench_data_file())

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    over_a = parse_overrides(args.a)
    arm_over = {"a": over_a, "b": {**over_a, **parse_overrides(args.b)}}
    table: Dict[str, Any] = {"card": card_line() if args.device != "cpu"
                             else "cpu", "data_file": data_file}
    per_seed = {}
    for arm in ("a", "b"):
        d = bench_workload(tag="ab_paired", save_artifacts=True,
                           n_experiments=args.n_experiments,
                           data_file=data_file, **arm_over[arm])
        cdir = out / arm
        wall_cold = wall = None
        if arm in args.arms:
            print(f"\n=== arm {arm}: {arm_over[arm] or 'baseline'} "
                  f"({args.n_experiments} seeds) ===", flush=True)
            warm = out / f"warmup_{arm}"
            warm_cfg = dict(d, base_seed=d["base_seed"] + WARMUP_SEED_OFFSET)
            if args.warmup_epochs is not None:
                warm_cfg["epochs"] = args.warmup_epochs
            t0 = time.time()
            try:
                run_multiple_experiments(ExperimentConfig.from_dict(warm_cfg),
                                         warm, engine="vmap",
                                         device=args.device)
            finally:
                shutil.rmtree(warm, ignore_errors=True)
            wall_cold = time.time() - t0
            print(f"  arm {arm}: warm-up {wall_cold:.1f} s", flush=True)
            shutil.rmtree(cdir, ignore_errors=True)
            t0 = time.time()
            run_multiple_experiments(ExperimentConfig.from_dict(d), cdir,
                                     engine="vmap", device=args.device)
            wall = time.time() - t0
        res = arm_results(cdir / "experiments", args.n_experiments)
        if not res["crps"]:
            continue
        per_seed[arm] = res
        crps = list(res["crps"].values())
        table[arm] = {
            "overrides": arm_over[arm], "n": len(crps),
            "test_crps_mean": float(np.mean(crps)),
            "test_crps_std": float(np.std(crps)),
            "test_rmse_mean": float(np.mean(list(res["rmse"].values()))),
            "wall_seconds": wall, "wall_seconds_cold": wall_cold,
            "crps": res["crps"], "rmse": res["rmse"],
        }
        e = table[arm]
        print(f"  arm {arm}: CRPS {e['test_crps_mean']:.5f} +- "
              f"{e['test_crps_std']:.5f}  RMSE {e['test_rmse_mean']:.5f}  "
              f"wall {wall if wall is None else round(wall, 1)} s", flush=True)
    if "a" in per_seed and "b" in per_seed:
        p = table["paired"] = paired(per_seed["a"], per_seed["b"])
        print(f"\npaired b-a CRPS delta = {p['crps_delta_mean']:+.6f} +- "
              f"{p['crps_delta_std']:.6f} over {p['n_pairs']} seeds "
              f"({p['crps_delta_sigma']:.2f} sigma of the mean)", flush=True)
        if table["a"]["wall_seconds"] and table["b"]["wall_seconds"]:
            ratio = table["b"]["wall_seconds"] / table["a"]["wall_seconds"]
            p["wall_ratio_b_over_a"] = ratio
            print(f"wall b / a = {ratio:.4f}", flush=True)
    save_json(table, out / "ab_summary.json")
    print(f"[OK] wrote {out / 'ab_summary.json'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
