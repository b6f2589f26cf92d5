"""Run one cell of the benchmark once.

    python3 -m stbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name, so a new cell, configuration, traffic mix,
driver or per-layer metric is a new file and a new entry, never an edit:

    BENCHMARK.json                    the cells (`workloads`) and metrics
    stbench/configs/<config>.json     the program's configuration ("program"),
                                      the field it trains on ("field"), the
                                      source and every key changed from it
    stbench/traffic/<traffic>.json    the driver's name and parameters, and
                                      the limits of the comparison
    stbench/drivers/<driver>.py       `run(ctx)`: set-up, the window, the
                                      comparison with the reference
    stbench/metrics/<metric>.py       `read(obs)`: one per-layer metric from
                                      the driver's observation, None where
                                      there is nothing to read

The run needs the card (`torch.cuda.is_available()` and as many devices as
the cell asks for): without it, it exits 2 and prints no result. It keeps
the program's builds in the checkout (`build/`) and its caches there too,
and its scratch files under TMPDIR, removed at exit. With `--trace 0` the
result holds the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics. The last line of standard output is the result; the last lines of
standard error are the numbers compared, each beside its limit. A run that
finds `jax`, `jaxlib`, `flax` or `st_dadk_tpu` loaded after the window
exits 4 and prints no result; a traced run whose span never opened, or in
which a per-layer metric of the cell found nothing to read, exits 5 and
prints no result (the program no longer calls what the yardstick
observes: `stbench/capture.py`).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "st_dadk_tpu")
THREADS = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules: Sequence[str]) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN: whole names, so `st_dadk_tpu_torch` is not one."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


class Layout:
    """Where the benchmark's files are: `root` holds BENCHMARK.json and the
    package directory `pkg` (default: this package)."""

    def __init__(self, pkg: Path = HERE):
        self.pkg = Path(pkg)
        self.root = self.pkg.parent

    def bench(self) -> Dict:
        with open(self.root / "BENCHMARK.json", "r", encoding="utf-8") as f:
            return json.load(f)

    def json(self, kind: str, name: str) -> Dict:
        path = self.pkg / kind / f"{name}.json"
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        path = self.pkg / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"stbench_{kind}_{name.replace('.', '_')}", path)
        if spec is None or not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} {name!r} at {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, workload: str) -> Dict:
        bench = self.bench()
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        cell = cells[workload]
        config = self.json("configs", cell["config"])
        traffic = self.json("traffic", cell["traffic"])
        return dict(bench=bench, cell=cell, config=config, traffic=traffic,
                    driver=self.module("drivers", traffic["driver"]))

    def metrics_of(self, bench: Dict, workload: str, section: str
                   ) -> List[Dict]:
        return [m for m in bench[section]
                if "workloads" not in m or workload in m["workloads"]]


class Ctx:
    """What a driver gets: the cell's files, the run's arguments, its
    device and scratch directory, and the hooks that record when set-up
    ends and the device's peak memory."""

    def __init__(self, found: Dict, seed: int, seconds: float, trace: bool,
                 device, tmp: Path, t_start: float, readings: bool = False):
        self.cell, self.config = found["cell"], found["config"]
        self.traffic = found["traffic"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.device, self.tmp, self.t_start = device, Path(tmp), t_start
        self.readings = readings
        self.setup_s: Optional[float] = None

    def window_started(self, t: float) -> None:
        self.setup_s = t - self.t_start

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def device_record(device, chips: int, peak: int) -> Dict:
    import torch
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": int(chips),
            "memory_peak_bytes": int(peak)}


def run_cell(layout: Layout, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             readings: bool = False) -> Dict:
    """Set-up, window and comparison of one cell on `device`: the result
    dict (with its checks), not yet printed. The card check is the
    caller's."""
    import torch
    found = layout.cell(workload)
    dev = torch.device(device)
    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    base.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="stbench-", dir=base))
    try:
        ctx = Ctx(found, seed, seconds, trace, dev, tmp, t_start, readings)
        out = found["driver"].run(ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bench, name = found["bench"], found["cell"]["name"]
    metrics: Dict[str, Dict] = {}
    if not trace:
        for m in layout.metrics_of(bench, name, "end_to_end"):
            value = (ctx.setup_s if m["name"] == "setup_s"
                     else out["e2e"].get(m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        silent = []
        for m in layout.metrics_of(bench, name, "per_layer"):
            value = layout.module("metrics", m["name"]).read(out["obs"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            else:
                silent.append(m["name"])
    checks = out["checks"]
    correct = (out["attempted"] > 0 and out["failed"] == 0
               and all(v <= lim for _, v, lim in checks))
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_record(dev, found["cell"]["chips"],
                                      out["memory_peak_bytes"])}
    span = out["obs"].get("span") if trace else None
    if span is not None:
        from stbench import yardstick
        result["device"]["busy_s"] = yardstick.busy_seconds(span["events"])
        result["device"]["window_s"] = span["window_s"]
        result["breakdown"] = yardstick.breakdown(span["events"])
    result["extra"] = dict(out.get("extra", {}), setup_s=ctx.setup_s)
    if trace:
        result["extra"].update(span_opened=span is not None, silent=silent)
    if span is not None:
        launches: Dict[str, int] = {}
        for (kernel, *_), count in span["launches"].items():
            launches[kernel] = launches.get(kernel, 0) + count
        result["extra"]["launches_in_span"] = launches
        if "fwd_launches_per_request" in span:
            result["extra"]["fwd_launches_per_request"] = \
                span["fwd_launches_per_request"]
    if readings:
        result["readings"] = out["readings"]
    result["checks"] = {n: {"value": float(v), "limit": float(lim)}
                        for n, v, lim in checks}
    return result


def trace_faults(result: Dict) -> List[str]:
    """What a traced run on the card failed to observe: its span never
    opened, or a per-layer metric of the cell found nothing to read."""
    extra, out = result["extra"], []
    if not extra["span_opened"]:
        out.append("the traced span never opened")
    if extra["silent"]:
        out.append("per-layer metrics with nothing to read: "
                   + ", ".join(extra["silent"]))
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m stbench",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", type=Path, default=None,
                    help="also compute the control's readings and write "
                         "every sampled comparison's readings to this file")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    layout = Layout()
    try:
        found = layout.cell(args.workload)
    except (KeyError, FileNotFoundError, OSError, ValueError) as e:
        log(f"stbench: {e}")
        return 2
    try:
        import torch
    except ImportError as e:
        log(f"stbench: {e}")
        return 2
    chips = int(found["cell"]["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        log(f"stbench: the cell needs {chips} CUDA device(s); available: "
            f"{have}")
        return 2
    if importlib.util.find_spec("st_dadk_tpu_torch") is None:
        log("stbench: the program (st_dadk_tpu_torch) is not in this checkout")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(THREADS)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(layout.root / "build" / "triton"))
    result = run_cell(layout, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", t_start,
                      readings=args.readings is not None)
    found_mods = forbidden_modules(list(sys.modules))
    if found_mods:
        log(f"stbench: loaded after the window: {', '.join(found_mods)}")
        return 4
    faults = trace_faults(result) if args.trace else []
    if faults:
        log("stbench: " + "; ".join(faults))
        return 5
    if args.readings is not None:
        args.readings.parent.mkdir(parents=True, exist_ok=True)
        args.readings.write_text(json.dumps(
            {"workload": args.workload, "seed": args.seed,
             "readings": result.pop("readings"), "extra": result["extra"],
             "checks": result["checks"]}, indent=1))
    for name, c in result["checks"].items():
        log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
