"""Fits per hour of the bench workload on one GPU (counterpart of the JAX
package's headline `bench.py`).

    python3 -m st_dadk_tpu_torch.bench [M] [--window_seconds 90] \\
        [--windows 5] [--lane_width 0] [--overrides JSON] \\
        [--details results/bench_torch/bench_details.json] [--device cuda]

The workload is `bench_workload()`: one full DA-STDK fit (500 epochs at
most, patience 50) on `dataio/synthetic.py::bench_data_file()`, which is
the real `data/2a/2a_8.csv` where the checkout has it and the stand-in
field otherwise. Each window streams whole batches of M jobs (default 16)
through the lane engine's pipeline (`train/batch_engine.py::
run_job_batches`: the next batch's host preparation and earlier batches'
finalizes overlap the training of the current one) until the window has
lasted `window_seconds`; batch bi of window wi takes the base seed
`seed_base + wi * 100000 + bi * 1000`. With `--lane_width w` below M each
batch of M jobs runs as w-lane batches, the last one ragged where w does
not divide M. The result is the median window's fits per hour with the
half-range spread in percent (the JAX tool's arithmetic, `window_summary`).

When a window ends: `run_job_batches` pulls its next batch from the
window's generator on the main thread when the batch it prepared before is
about to train, and hands it to the prepare thread. The time check runs in
that pull, so a window ends one prepared batch after its seconds have
passed, and its wall includes the finalizes still in flight. The JAX
tool's pipeline consumes its generator the same way.

What differs from the JAX tool, for the card:
  - Warm-up. The JAX tool warms to compile. The port compiles no program,
    but its first batch builds both `.cu` files with nvcc, parses the CSV
    (or writes the stand-in) and creates cuBLAS's handles. So one warm
    batch runs per distinct batch width, each cut to WARM_EPOCHS epochs
    (12: the basis unfreezes at epoch 10, so the warm batch runs every
    stage a full fit runs) or the workload's epochs where fewer, and its
    seconds are recorded.
  - Golden probe. Both of the JAX tool's arms are kept as raw values
    recorded each window, on the card only: a pinned chain of 1024
    tanh(c @ c) + 0.001 steps on a bf16 2048 x 2048 matrix (`device_s`,
    the median of 3), and 100 one-element launches each followed by a host
    read (`roundtrip_ms` a trip), the arm that tracks this host-bound
    program's drift. The JAX tool's reference values and its calibrated
    rate are not carried: they were taken on a TPU, and no H100 reference
    is pinned yet.
  - Baseline. `vs_baseline` divides by the JAX tool's baseline, the
    reference code's 35 fits/hour on one CPU core on the real 2a_8
    (`baselines/reference_cpu.json`) times 10 (its joblib n_jobs=10).
    Early stopping sets a fit's length, so the details file records the
    data file and the mean epochs run beside it.
  - Accuracy. The reference's CPU scores are quoted only on the real 2a_8;
    on the stand-in the JAX package's 30-seed scores on the same field
    (`results/port_accuracy/n30/table.md`, JAX vmap).

The JAX tool's environment knobs give the flags' defaults:
BENCH_WINDOW_SECONDS, BENCH_WINDOWS, BENCH_LANE_WIDTH, BENCH_OVERRIDES (a
JSON object of config overrides) and BENCH_DETAILS. The details file
(never the JAX tool's `bench_details.json`) is written after every window
and at the end: the data file, the warm-up, each window's fits, jobs,
wall, rate, probe values, seeds and scores, the kernels' launches over the
windows, the last window's mean `n_epochs_run`, test CRPS and RMSE, and
the device. The last line of standard output is one JSON object:
{"metric": "fits_per_hour", "value", "unit", "vs_baseline", "device"}.
The card is required unless `--device cpu` is passed (the tests); a CPU
run's numbers are no device metric.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from st_dadk_tpu_torch.bench_workload import bench_workload
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.dataio.synthetic import bench_data_file, standin_path
from st_dadk_tpu_torch.ops import fused_first_layer as ffl
from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
from st_dadk_tpu_torch.train.batch_engine import (run_job_batch,
                                                  run_job_batches)
from st_dadk_tpu_torch.utils.timing import device_record, require_device

REPO = Path(__file__).resolve().parents[1]
DEFAULT_DETAILS = REPO / "results" / "bench_torch" / "bench_details.json"
BASELINE_FITS_PER_HOUR_1CORE = 35.0
BASELINE_JOBLIB10_PROXY = BASELINE_FITS_PER_HOUR_1CORE * 10.0
SEED_BASE, WARM_SEED = 2025, 9999
WARM_EPOCHS = 12
REAL_DATA = REPO / "data" / "2a" / "2a_8.csv"
# test scores to quote beside the run's: the reference code on the CPU on
# the real 2a_8 (the JAX tool's print), and the JAX package's 30 seeds on
# the stand-in field (results/port_accuracy/n30/table.md, JAX vmap)
REFERENCE_SCORES = {
    "real": {"source": "reference CPU", "test_crps": (0.484, 0.013),
             "test_rmse": (0.963, None)},
    "standin": {"source": "JAX package, 30 seeds, stand-in field",
                "test_crps": (0.5206, 0.0188),
                "test_rmse": (0.9898, 0.0361)},
}
PROBE_SIDE, PROBE_STEPS, PROBE_TRIPS = 2048, 1024, 100


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def window_summary(rates: Sequence[float]) -> tuple:
    """(median window's rate, +- half-range spread in percent of it): the
    upper median of an even count, as the JAX tool takes it."""
    rates = sorted(rates)
    median = rates[len(rates) // 2]
    spread_pct = ((rates[-1] - rates[0]) / median * 50.0
                  if median else 0.0)
    return median, spread_pct


def lane_widths(M: int, lane_width: int) -> List[int]:
    """Every distinct batch width of an M-job split into lane_width-lane
    batches (one width M without a split), widest first."""
    if not lane_width or lane_width >= M:
        return [M]
    return sorted({min(lane_width, M - i) for i in range(0, M, lane_width)},
                  reverse=True)


def split(jobs: List, lane_width: int) -> List[List]:
    if lane_width and lane_width < len(jobs):
        return [jobs[c:c + lane_width]
                for c in range(0, len(jobs), lane_width)]
    return [jobs]


def data_kind(data_file: str) -> Optional[str]:
    """'real' for the real 2a_8, 'standin' for the stand-in field, else
    None."""
    path = ExperimentConfig(data_file=data_file).resolve_data_file().resolve()
    if path == REAL_DATA.resolve():
        return "real"
    if path == standin_path().resolve():
        return "standin"
    return None


def make_probe(device: torch.device) -> Optional[Callable[[], Dict]]:
    """The golden probe's two arms on the card (module docstring); None on
    the CPU."""
    if device.type != "cuda":
        return None
    x_mm = torch.full((PROBE_SIDE, PROBE_SIDE), 0.001, dtype=torch.bfloat16,
                      device=device)
    x_tiny = torch.ones(1, device=device)

    def chain() -> float:
        c = x_mm
        for _ in range(PROBE_STEPS):
            c = torch.tanh(c @ c) + 0.001
        return float(c[0, 0])            # the host read is the barrier

    def trips() -> float:
        x = x_tiny.clone()
        t0 = time.perf_counter()
        for _ in range(PROBE_TRIPS):
            x.add_(1e-6)
            float(x[0])
        return (time.perf_counter() - t0) / PROBE_TRIPS * 1e3

    chain()
    trips()

    def probe() -> Dict[str, float]:
        dev = []
        for _ in range(3):
            t0 = time.perf_counter()
            chain()
            dev.append(time.perf_counter() - t0)
        return {"device_s": sorted(dev)[1], "roundtrip_ms": trips()}

    return probe


def _launches() -> Dict[str, int]:
    return {**ffl.launch_counts(), **sbk.launch_counts()}


def run(M: int, window_seconds: float, n_windows: int, lane_width: int,
        overrides: Dict[str, Any], details_path: Path,
        device: torch.device) -> Dict[str, Any]:
    """The whole protocol (module docstring): the details dict, also
    written to `details_path`."""
    base = bench_workload(**overrides)
    if "data_file" not in overrides:
        base["data_file"] = str(bench_data_file())
    kind = data_kind(base["data_file"])
    record = device_record(device)
    details: Dict[str, Any] = {
        "M": M, "overrides": overrides, "lane_width": lane_width or M,
        "data_file": base["data_file"], "data_kind": kind,
        "protocol": f"median of {n_windows} windows, each >= "
                    f"{window_seconds:g} s of whole pipelined batches",
        "device": record}
    details_path.parent.mkdir(parents=True, exist_ok=True)

    def dump(partial: bool) -> None:
        details["partial"] = partial
        details_path.write_text(json.dumps(details, indent=2))

    def jobs_for(seed: int, out: Path) -> List:
        cfg = ExperimentConfig.from_dict({**base, "base_seed": seed})
        return [(cfg, i, out / str(i)) for i in range(1, M + 1)]

    tmp = Path(tempfile.mkdtemp(prefix="stdadk_bench_torch_"))
    try:
        widths = lane_widths(M, lane_width)
        warm_cfg = dict(base, epochs=min(WARM_EPOCHS, int(base["epochs"])))
        log(f"[bench] warm-up batches (widths {widths}, "
            f"{warm_cfg['epochs']} epochs)")
        details["warmup"] = {"epochs": warm_cfg["epochs"], "seconds": {}}
        for w in widths:
            cfg = ExperimentConfig.from_dict({**warm_cfg,
                                              "base_seed": WARM_SEED})
            t0 = time.perf_counter()
            run_job_batch([(cfg, i, tmp / f"warm_{w}" / str(i))
                           for i in range(1, w + 1)], device=device)
            secs = time.perf_counter() - t0
            details["warmup"]["seconds"][str(w)] = secs
            log(f"[bench] warm-up batch of width {w} in {secs:.1f} s")

        probe = make_probe(device)
        windows: List[Dict[str, Any]] = []
        details["windows"] = windows
        results: List[Dict[str, Any]] = []
        ffl.reset_launch_counts()
        sbk.reset_launch_counts()
        for wi in range(n_windows):
            golden = probe() if probe is not None else None
            seeds: List[int] = []
            jobs_run = [0]
            t0 = time.perf_counter()

            def gen(wi=wi, t0=t0, seeds=seeds, jobs_run=jobs_run
                    ) -> Iterator[List]:
                # whole batches until the window has lasted its seconds
                bi = 0
                while True:
                    seed = SEED_BASE + wi * 100000 + bi * 1000
                    seeds.append(seed)
                    jobs = jobs_for(seed, tmp / f"w{wi}b{bi}")
                    jobs_run[0] += len(jobs)
                    yield from split(jobs, lane_width)
                    bi += 1
                    if time.perf_counter() - t0 >= window_seconds:
                        return

            results = run_job_batches(gen(), device=device)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            fits = len(results)
            rate = fits / wall * 3600.0
            windows.append({
                "fits": fits, "jobs": jobs_run[0], "wall_seconds": wall,
                "fits_per_hour": rate, "golden": golden, "seeds": seeds,
                "test_crps": [r["test_crps"] for r in results],
                "test_rmse": [r["test_rmse"] for r in results],
                "n_epochs_run": [r["n_epochs_run"] for r in results]})
            log(f"[bench] window {wi}: {fits} fits in {wall:.1f} s -> "
                f"{rate:.1f} fits/hr"
                + ("" if golden is None else
                   f" (probe: chain {golden['device_s']:.4f} s, trip "
                   f"{golden['roundtrip_ms']:.4f} ms)"))
            dump(partial=True)

        launches = _launches()
        fits_per_hour, spread_pct = window_summary(
            [w["fits_per_hour"] for w in windows])
        crps = [r["test_crps"] for r in results]
        rmse = [r["test_rmse"] for r in results]
        details.update({
            "fits_per_hour": fits_per_hour,
            "window_spread_pct": spread_pct,
            "launches": launches,
            "mean_n_epochs_run_last_window": float(np.mean(
                [r["n_epochs_run"] for r in results])),
            "test_crps_last_window": crps, "test_rmse_last_window": rmse,
            "test_crps_mean_last_window": float(np.mean(crps)),
            "test_rmse_mean_last_window": float(np.mean(rmse)),
            "reference_scores": REFERENCE_SCORES.get(kind),
            "baseline_1core_fits_per_hour": BASELINE_FITS_PER_HOUR_1CORE,
            "baseline_joblib10_proxy": BASELINE_JOBLIB10_PROXY,
        })
        dump(partial=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return details


def _quote(ref: Optional[Dict[str, Any]], metric: str) -> str:
    if ref is None:
        return ""
    mean, std = ref[metric]
    return (f" ({ref['source']}: {mean}"
            + ("" if std is None else f" +/- {std}") + ")")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The flags; the JAX tool's BENCH_* variables give their defaults."""
    env = os.environ
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("M", nargs="?", type=int, default=16,
                    help="jobs a batch")
    ap.add_argument("--window_seconds", type=float,
                    default=float(env.get("BENCH_WINDOW_SECONDS", 90.0)))
    ap.add_argument("--windows", type=int,
                    default=int(env.get("BENCH_WINDOWS", 5)))
    ap.add_argument("--lane_width", type=int,
                    default=int(env.get("BENCH_LANE_WIDTH", 0)),
                    help="split each batch of M jobs into batches of this "
                         "many lanes (0: one M-lane batch)")
    ap.add_argument("--overrides", default=env.get("BENCH_OVERRIDES", "{}"),
                    help="JSON object of config overrides")
    ap.add_argument("--details", type=Path,
                    default=Path(env.get("BENCH_DETAILS", DEFAULT_DETAILS)))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.M < 1 or args.windows < 1:
        ap.error("M and --windows must be at least 1")
    return args


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    try:
        device = require_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    overrides = json.loads(args.overrides)
    if overrides and args.details.resolve() == DEFAULT_DETAILS.resolve():
        log("[bench] WARNING: overrides without a --details path of their "
            "own: the default details file now holds an overridden "
            "workload's run")
    d = run(args.M, args.window_seconds, args.windows, args.lane_width,
            overrides, args.details, device)
    rates = sorted(w["fits_per_hour"] for w in d["windows"])
    ref = d["reference_scores"]
    log(f"[bench] median window: {d['fits_per_hour']:.1f} fits/hr (spread "
        f"+/-{d['window_spread_pct']:.1f}% over {len(rates)} windows, range "
        f"{rates[0]:.0f}-{rates[-1]:.0f}); data {d['data_file']}, mean "
        f"epochs run {d['mean_n_epochs_run_last_window']:.1f}")
    log(f"[bench] test CRPS mean={d['test_crps_mean_last_window']:.4f}"
        f"{_quote(ref, 'test_crps')}; test RMSE mean="
        f"{d['test_rmse_mean_last_window']:.4f}{_quote(ref, 'test_rmse')}")
    log(f"[bench] details: {args.details}")
    print(json.dumps({
        "metric": "fits_per_hour",
        "value": d["fits_per_hour"],
        "unit": "fits/hour",
        "vs_baseline": d["fits_per_hour"] / BASELINE_JOBLIB10_PROXY,
        "device": d["device"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
