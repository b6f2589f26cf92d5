"""Profile the step loop of the bench-workload fit on one GPU.

    python3 -m st_dadk_tpu_torch.profile_fit [--out build/profile_fit.json]

One process sets up the bench workload (stand-in field unless
`data/2a/2a_8.csv` exists) once, then runs `train.loop.fit` for
`EPOCHS` epochs five times, each from the same initial weights and seed:

  1. a warm-up fit: the process's first launch of every kernel;
  2. `REPEATS` fits without the profiler: wall seconds and ms a step of each,
     and the spread between them;
  3. one fit under `torch.profiler`: device activities (kernels, copies,
     memsets), their summed device time, the union of their intervals, and
     the busy share = union / the wall time of that same profiled fit.

The profiler slows the host, so the busy share it reports is lower than
that of an unprofiled fit; the JSON also gives the profiled fit's wall
against the unprofiled median. Writes `--out` (JSON) and the profiler's
table beside it (`.txt`).
"""
from __future__ import annotations

import argparse
import copy
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
EPOCHS = 12       # the fit chip_smoke.py runs: the basis trains from epoch 10
REPEATS = 3
# a csrc kernel's demangled name: "(anonymous namespace)::bwd_w_kernel(...)",
# "void (anonymous namespace)::fwd_kernel<16, 64, ...>(...)" (a template),
# "st_slabs::centers_sum_kernel(...)" (csrc/slabs.cuh)
PORT_KERNEL = re.compile(
    r"(?:void )?(?:\(anonymous namespace\)|st_slabs)::"
    r"((?:fwd|bwd_w|bwd_centers|bwd_points|slab_sum|centers_sum)_kernel)[<(]")


def _timed_fit(loop, cfg, setup, init_state, seed):
    setup.model.load_state_dict(init_state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = loop.fit(cfg, setup.spec, setup.model, setup.train_ps,
                   setup.valid_ps, seed=seed)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _per_step(res):
    """ms a step over the whole fit, in epoch 1 and in epochs 2 onwards."""
    t, first = (res.timings["train_steps_seconds"],
                res.timings["first_epoch_steps_seconds"])
    per_epoch = res.n_steps // res.n_epochs_run
    return {"ms_per_step": 1e3 * t / res.n_steps,
            "epoch1_ms_per_step": 1e3 * first / per_epoch,
            "later_ms_per_step": 1e3 * (t - first) / (res.n_steps - per_epoch)}


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=REPO / "build" /
                    "profile_fit.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fit: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from torch.profiler import ProfilerActivity, profile

    from st_dadk_tpu_torch.bench_workload import bench_workload
    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.dataio.synthetic import bench_data_file
    from st_dadk_tpu_torch.train import loop
    from st_dadk_tpu_torch.train.experiment import ExperimentSetup

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    cfg = ExperimentConfig.from_dict(bench_workload(
        data_file=str(bench_data_file()), epochs=EPOCHS))
    setup = ExperimentSetup(cfg, 1, "cuda")
    init_state = copy.deepcopy(setup.model.state_dict())
    seed = setup.experiment_seed

    res, wall = _timed_fit(loop, cfg, setup, init_state, seed)
    steps = res.n_steps
    warm = {"wall_s": wall, **_per_step(res)}
    runs = []
    for i in range(REPEATS):
        res, wall = _timed_fit(loop, cfg, setup, init_state, seed)
        runs.append({"wall_s": wall, **_per_step(res)})
    for name, r in [("warm-up fit", warm)] + [(f"fit {i + 1}", r) for i, r
                                              in enumerate(runs)]:
        print(f"{name}: {r['wall_s']:.4f} s, {r['ms_per_step']:.3f} ms a step"
              f" (epoch 1 {r['epoch1_ms_per_step']:.3f}, epochs 2-{EPOCHS} "
              f"{r['later_ms_per_step']:.3f}; {steps} steps)", flush=True)
    walls = [r["wall_s"] for r in runs]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res, prof_wall = _timed_fit(loop, cfg, setup, init_state, seed)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time for e in dev) / 1e3
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in dev]) / 1e3
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    # the port's own kernels (csrc/*.cu and the slab sums of csrc/slabs.cuh),
    # by function name (template arguments dropped), a step
    ours = {}
    for name, ms in by_name.items():
        m = PORT_KERNEL.match(name)
        if m:
            ours[m.group(1)] = ours.get(m.group(1), 0.0) + ms / steps

    report = {
        "card": card, "epochs": EPOCHS, "steps": steps,
        "warmup_fit": warm, "fits": runs,
        "wall_s_median": statistics.median(walls),
        "wall_s_spread": (max(walls) - min(walls)) / statistics.median(walls),
        "profiled": {
            "wall_s": prof_wall,
            "wall_vs_unprofiled_median": prof_wall / statistics.median(walls),
            "device_activities": len(dev),
            "device_activities_per_step": len(dev) / steps,
            "device_ms": dev_ms, "device_ms_per_step": dev_ms / steps,
            "busy_ms": busy_ms,
            "busy_share": busy_ms / (1e3 * prof_wall),
            "top_device_ms": top,
            "port_kernels_ms_per_step": ours,
        },
    }
    p = report["profiled"]
    print(f"profiled fit: {prof_wall:.4f} s wall "
          f"({p['wall_vs_unprofiled_median']:.3f}x the unprofiled median), "
          f"{len(dev)} device activities "
          f"({p['device_activities_per_step']:.1f} a step incl. validation), "
          f"{dev_ms:.3f} ms device time ({p['device_ms_per_step']:.4f} ms a "
          f"step), busy {busy_ms:.3f} ms = share {p['busy_share']:.4f} of "
          f"the same fit's wall", flush=True)
    for name, ms in top:
        print(f"  {ms:9.3f} ms  {name[:90]}")
    print("the port's kernels, device ms a step: " + ", ".join(
        f"{k} {v:.5f}" for k, v in sorted(ours.items())), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    args.out.with_suffix(".txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=25))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
