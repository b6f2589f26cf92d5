"""Trace-backed account of the lane engine's pipelined steady state on one
GPU (port of `scripts/trace_steady_state.py`).

    python3 -m st_dadk_tpu_torch.trace_steady_state capture \
        [--batches 6] [--lanes 16] [--epochs 3] [--no-ops] \
        [--out build/trace_steady]
    python3 -m st_dadk_tpu_torch.trace_steady_state analyze \
        [--out build/trace_steady]

capture: one warm-up batch of the bench workload (stand-in field unless
`data/2a/2a_8.csv` exists; the process's first launch of every kernel, as
`profile_fit.py` warms up), then a pipelined stream of `--batches` batches
of `--lanes` lanes, `--epochs` epochs each (`batch_engine.run_job_batches`:
prepare and finalize threads beside the main thread's init and fit) under
`torch.profiler` with CPU and CUDA activities. The engine carries no spans
of its own: for the capture only, this module wraps the engine's stages
(`_prepare_job_batch`; `_execute_job_batch` and, inside it, the upload with
`_init_lane_carries` and `fit_lanes`; `_finalize_job_batch`) in
`torch.profiler.record_function` ranges and records every stage on the
host's clock as well: the profiler records the ops and ranges of the
calling thread only (all threads cost it tens of seconds of export for a
short window), while CUPTI traces every thread's launches; the host spans
place the other threads' stages on the trace's clock. The profiler's Chrome
trace is reduced (`compact`) to what the analysis reads and kept as
`trace.json.gz` beside `capture_meta.json`; the raw export is deleted.

analyze (host only, no card): every device activity (kernel, copy, memset)
is attributed by the host launch that correlates with it: the launching
thread, the innermost PyTorch op around the launch (main thread; elsewhere
the kernel's name stands for it), and the stack of stage ranges around it
on that thread, or on the main thread at that time where the launching
thread has none (autograd runs the backward of CUDA tensors on a thread of
its own while the main thread waits in `backward`).
Families: 'init' (upload, spatial init and models), 'fit step' (steps and
validation), 'eval/finalize', 'copy H2D' and 'copy D2H' (every host-device
copy, whatever stage issued it), 'other'.
Reported (`report.json`, and printed): merged device-busy seconds by family
over the traced span, the queue gaps between busy intervals with what the
main thread was doing, and a steady-state table, one row a batch period
(from one batch's execute start to the next; the first and last batch, the
pipeline's spin-up and tail, are left out), in which the device time of
each family plus the idle time sums to the period exactly; beside it the
same periods on the capture's own clock. The copies' share of the steady
batch wall decides whether packed transfers pay (ROADMAP Queue 1).
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import gzip
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

REPO = Path(__file__).resolve().parents[1]
DEFAULT_OUT = REPO / "build" / "trace_steady"
FAMILIES = ("init", "fit step", "eval/finalize", "copy H2D", "copy D2H",
            "other")
STAGE_FAMILY = {"init": "init", "fit": "fit step",
                "finalize": "eval/finalize"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STAGE_PREFIX = "stage:"
GAP_MIN_US = 1000.0              # gaps listed: at least 1 ms


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# capture
# --------------------------------------------------------------------------

@contextlib.contextmanager
def staged_engine(starts: List[float], spans: List[tuple]):
    """The engine's stages wrapped in record_function ranges named
    'stage:<stage>' for the duration of the block. `starts` collects the
    host clock (time.time) at the start of each batch's execute stage,
    `spans` every stage as (native thread id, stage, start ns, end ns) on
    the host's clock: the profiler records the ranges of the calling
    thread only, and these place the pipeline threads' stages."""
    import threading

    import torch

    from st_dadk_tpu_torch.train import batch_engine as be

    def wrap(fn, stage, first=None):
        def staged(*a, **kw):
            if first is not None:
                first.append(time.time())
            t0 = time.time_ns()
            try:
                with torch.profiler.record_function(STAGE_PREFIX + stage):
                    return fn(*a, **kw)
            finally:
                spans.append((threading.get_native_id(), stage, t0,
                              time.time_ns()))
        return staged

    saved = {n: getattr(be, n) for n in ("_prepare_job_batch",
                                         "_execute_job_batch", "lane_data_to",
                                         "_init_lane_carries", "fit_lanes",
                                         "_finalize_job_batch")}
    be._prepare_job_batch = wrap(saved["_prepare_job_batch"], "prepare")
    be._execute_job_batch = wrap(saved["_execute_job_batch"], "execute",
                                 starts)
    be.lane_data_to = wrap(saved["lane_data_to"], "init")
    be._init_lane_carries = wrap(saved["_init_lane_carries"], "init")
    be.fit_lanes = wrap(saved["fit_lanes"], "fit")
    be._finalize_job_batch = wrap(saved["_finalize_job_batch"], "finalize")
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(be, n, fn)


def compact(trace: Dict[str, Any],
            spans: Optional[List[tuple]] = None) -> Dict[str, Any]:
    """What `analyze` reads of a torch.profiler Chrome trace, each as a
    short list (times in the trace's microseconds): the device activities;
    the runtime calls that launched them, each with the innermost CPU op
    around it on its thread where the trace holds CPU ops; and the stage
    ranges, the traced ones and, from the host `spans` of `staged_engine`,
    those of the threads the profiler recorded no range on
    (`_host_stages`)."""
    dev, launch, stages = [], [], []
    ops = defaultdict(list)
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, dur, cat, e.get("name", ""),
                        args.get("correlation")))
        elif cat in LAUNCH_CATS and args.get("correlation") is not None:
            launch.append((ts, dur, e.get("tid"), args["correlation"]))
        elif cat == "user_annotation" and \
                str(e.get("name", "")).startswith(STAGE_PREFIX):
            stages.append((ts, dur, e.get("tid"),
                           e["name"][len(STAGE_PREFIX):]))
        elif cat == "cpu_op":
            ops[e.get("tid")].append((ts, ts + dur, e.get("name", "")))
    ops = {tid: _Spans(rows) for tid, rows in ops.items()}
    launch = [row + ((ops[row[2]].holding(row[0]) or [None])[0]
                     if row[2] in ops else None,) for row in launch]
    if spans:
        stages += _host_stages(stages, spans, launch,
                               trace.get("baseTimeNanoseconds"))
    return {"device": dev, "launch": launch, "stages": stages}


def _host_stages(traced: List[tuple], spans: List[tuple],
                 launch: List[tuple], base_ns: Optional[int]) -> List[tuple]:
    """The host `spans` (native thread id, stage, start ns, end ns) of the
    threads with no traced range, as trace stages (ts, dur, tid, stage).

    The clock: the median offset between the traced ranges and the host's
    where a thread has both, else the trace's base time (its microseconds
    count from `baseTimeNanoseconds` on the host's wall clock). The thread:
    a launching thread the trace names by another id than the host's (the
    profiler names threads it recorded no op on by their CUDA-runtime id)
    takes the host thread whose stages hold at least 90 % of its launches
    and cover the least of the traced time for it, the thread with the
    highest share inside over share of time covered."""
    import statistics
    by_key = defaultdict(list)
    for ts, _, tid, name in sorted(traced):
        by_key[(tid, name)].append(ts)
    host = defaultdict(list)
    for tid, name, t0, t1 in sorted(spans, key=lambda r: r[2]):
        host[(tid, name)].append((t0, t1))
    offsets = [ts - t0 / 1e3 for key, rows in host.items()
               for ts, (t0, _) in zip(by_key.get(key, ()), rows)]
    if offsets:
        off = statistics.median(offsets)
    elif base_ns is not None:
        off = -float(base_ns) / 1e3
    else:
        off = 0.0
    seen = {tid for _, _, tid, _ in traced}
    threads = defaultdict(list)
    for (tid, name), rows in host.items():
        if tid not in seen:
            threads[tid] += [(t0 / 1e3 + off, t1 / 1e3 + off, name)
                             for t0, t1 in rows]
    if not threads:
        return []
    times = defaultdict(list)
    for ts, _, tid, _, _ in launch:
        times[tid].append(ts)
    lo = min(min(v) for v in times.values()) if times else 0.0
    hi = max(max(v) for v in times.values()) if times else 1.0
    merged = {h: _merge([(a, b) for a, b, _ in rows])
              for h, rows in threads.items()}
    cover = {h: max(sum(b - a for a, b in m) / max(hi - lo, 1e-9), 1e-9)
             for h, m in merged.items()}
    alias = defaultdict(set)
    for tid, ts_list in times.items():
        if tid in seen or tid in threads:
            continue
        best, lift = None, 0.0
        for h, m in merged.items():
            starts = [a for a, _ in m]
            inside = sum(1 for t in ts_list
                         if (i := bisect.bisect_right(starts, t) - 1) >= 0
                         and m[i][1] >= t) / len(ts_list)
            if inside >= 0.9 and inside / cover[h] > lift:
                best, lift = h, inside / cover[h]
        if best is not None:
            alias[best].add(tid)
    return [(a, b - a, t, name) for h, rows in threads.items()
            for t in {h} | alias[h] for a, b, name in rows]


def capture(out_dir: Path, n_batches: int, lanes: int, epochs: int,
            ops: bool = True, warmup: bool = True) -> Dict:
    """The capture (module docstring); `ops=False` records the CUDA
    activities alone (no CPU op, so no op names in the analysis: the
    kernel's name stands for it), a trace a fraction of the size;
    `warmup=False` skips the warm-up batch where the process has run the
    engine's paths already."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from st_dadk_tpu_torch.bench_workload import bench_workload
    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.dataio.synthetic import bench_data_file
    from st_dadk_tpu_torch.train import batch_engine as be

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = bench_workload(data_file=str(bench_data_file()), epochs=epochs)
    work = out_dir / "work"

    def jobs_for(seed: int, name: str):
        cfg = ExperimentConfig.from_dict({**base, "base_seed": seed})
        return [(cfg, i, work / name / str(i)) for i in range(1, lanes + 1)]

    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    if warmup:
        be.run_job_batch(jobs_for(9999, "warm"), device="cuda")
        torch.cuda.synchronize()
        log(f"[trace] warm-up batch of {lanes} lanes in "
            f"{time.time() - t0:.1f} s")
    batches = [jobs_for(2025 + 1000 * b, f"b{b}") for b in range(n_batches)]
    starts: List[float] = []
    spans: List[tuple] = []
    raw = out_dir / "raw_trace.json"
    activities = ([ProfilerActivity.CPU] if ops else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        with staged_engine(starts, spans):
            t0 = time.time()
            results = be.run_job_batches(batches, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t0
    t1 = time.time()
    prof.export_chrome_trace(str(raw))
    t2 = time.time()
    with open(raw) as f:
        trace = compact(json.load(f), spans)
    raw.unlink()
    t3 = time.time()
    (out_dir / "trace.json.gz").write_bytes(
        gzip.compress(json.dumps(trace).encode(), compresslevel=1))
    meta = {"lanes": lanes, "n_batches": n_batches, "epochs": epochs,
            "ops": ops, "events": {k: len(v) for k, v in trace.items()},
            "fits": len(results), "wall_seconds": wall,
            "fits_per_hour_in_window": len(results) / wall * 3600.0,
            "export_seconds": time.time() - t1,
            "export_split_seconds": {"profiler_exit": t1 - t0 - wall,
                                     "chrome_export": t2 - t1,
                                     "load_and_reduce": t3 - t2,
                                     "write": time.time() - t3},
            "batch_starts_host": [s - t0 for s in starts],
            "epochs_run": sorted({r["n_epochs_run"] for r in results})}
    (out_dir / "capture_meta.json").write_text(json.dumps(meta, indent=1))
    log(f"[trace] {n_batches} batches x {lanes} lanes in {wall:.2f} s "
        f"({meta['fits_per_hour_in_window']:.0f} fits an hour in the window)"
        f"; trace export and reduction {meta['export_seconds']:.1f} s")
    return meta


# --------------------------------------------------------------------------
# analysis
# --------------------------------------------------------------------------

def _merge(intervals):
    """Merged (start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Spans:
    """Ranges of one thread, sorted by start: the innermost range holding
    a time (the latest start among the ranges that hold it)."""

    def __init__(self, rows):
        self.rows = sorted(rows)
        self.starts = [r[0] for r in self.rows]

    def holding(self, ts: float, look_back: int = 64) -> List[Any]:
        """Every range that holds ts, innermost first (at most `look_back`
        ranges before ts are searched)."""
        i = bisect.bisect_right(self.starts, ts) - 1
        out = []
        while i >= 0 and look_back > 0:
            s, e, name = self.rows[i]
            if e >= ts:
                out.append(name)
            i -= 1
            look_back -= 1
        return out


class _Timeline:
    """The stage ranges of one thread cut at their ends: for a time, the
    innermost stage holding it and the innermost one that names a family
    (STAGE_FAMILY), by one bisection."""

    def __init__(self, rows):
        rows = sorted(rows)
        self.bounds = sorted({t for a, b, _ in rows for t in (a, b)})
        self.labels = []
        for a, b in zip(self.bounds, self.bounds[1:]):
            mid = (a + b) / 2
            # innermost first: the latest start, the earliest end on ties
            held = [name for s, _, name in sorted(
                (s, -e, name) for s, e, name in rows if s <= mid < e)][::-1]
            self.labels.append(
                (held[0] if held else None,
                 next((n for n in held if n in STAGE_FAMILY), None)))

    def at(self, ts: float):
        """(innermost stage, innermost family stage) at ts, each None where
        none holds it."""
        i = bisect.bisect_right(self.bounds, ts) - 1
        if 0 <= i < len(self.labels):
            return self.labels[i]
        return None, None


def _copy_kind(name: str) -> Optional[str]:
    n = name.lower()
    if "htod" in n:
        return "copy H2D"
    if "dtoh" in n:
        return "copy D2H"
    return None


def main_thread(tr: Dict[str, Any]):
    """The thread that ran the fits."""
    return next((tid for _, _, tid, n in tr["stages"] if n == "fit"), None)


def _timelines(tr: Dict[str, Any]) -> Dict[Any, _Timeline]:
    rows = defaultdict(list)
    for ts, dur, tid, name in tr["stages"]:
        rows[tid].append((ts, ts + dur, name))
    return {tid: _Timeline(r) for tid, r in rows.items()}


def attribute(tr: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Each device activity with its family, launching thread, op and
    innermost stage."""
    launches = {c: (ts, tid, op) for ts, _, tid, c, op in tr["launch"]}
    lines = _timelines(tr)
    main = lines.get(main_thread(tr))
    out = []
    for ts, dur, cat, name, corr in tr["device"]:
        host = launches.get(corr)
        tid, op, stage, fam = None, None, None, None
        if host is not None:
            tid, op = host[1], host[2]
            line = lines.get(tid)
            stage, fam = line.at(host[0]) if line else (None, None)
            if stage is None and main is not None:
                stage, fam = main.at(host[0])
        family = ((_copy_kind(name) if cat == "gpu_memcpy" else None)
                  or STAGE_FAMILY.get(fam, "other"))
        out.append({"ts": ts, "end": ts + dur, "family": family,
                    "thread": tid, "op": op, "stage": stage, "name": name})
    return out


def _segments(events, lo: float, hi: float) -> Dict[str, float]:
    """Microseconds of [lo, hi) by family: each stretch goes to the family
    of the earliest-started device activity covering it (FAMILIES order on
    ties), else to 'idle'. The values sum to hi - lo. One sweep in start
    order: an activity takes what it covers past the end of all earlier
    ones, which is exactly the stretch where it is the earliest started."""
    inside = sorted((max(e["ts"], lo), FAMILIES.index(e["family"]),
                     min(e["end"], hi)) for e in events
                    if e["end"] > lo and e["ts"] < hi)
    out = defaultdict(float)
    covered = lo
    for start, fam, end in inside:
        if end > covered:
            out[FAMILIES[fam]] += end - max(start, covered)
            covered = end
    out["idle"] = (hi - lo) - sum(out.values())
    return dict(out)


def analyze(out_dir: Path, trace: Optional[Dict[str, Any]] = None,
            meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The report (module docstring) of `out_dir`'s capture, or of a
    compacted `trace` and its `meta` given directly; written to
    out_dir/report.json where `out_dir` is given."""
    if trace is None:
        trace = json.loads(gzip.decompress(
            (Path(out_dir) / "trace.json.gz").read_bytes()))
    if meta is None:
        p = Path(out_dir) / "capture_meta.json"
        meta = json.loads(p.read_text()) if p.exists() else {}
    events = attribute(trace)
    if not events:
        raise SystemExit("no device activity in the trace")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["end"] for e in events)
    busy = _merge([(e["ts"], e["end"]) for e in events])
    by_family = defaultdict(list)
    for e in events:
        by_family[e["family"]].append((e["ts"], e["end"]))
    family_s = {f: sum(b - a for a, b in _merge(v)) / 1e6
                for f, v in by_family.items()}
    ops = defaultdict(float)
    threads = defaultdict(lambda: defaultdict(float))
    for e in events:
        ops[(e["family"], e["op"] or e["name"][:60])] += (e["end"]
                                                          - e["ts"]) / 1e6
        threads[str(e["thread"])][e["family"]] += (e["end"] - e["ts"]) / 1e6

    main = main_thread(trace)
    main_line = _timelines(trace).get(main)
    gaps = []
    for (_, e1), (s2, _) in zip(busy, busy[1:]):
        if s2 - e1 >= GAP_MIN_US:
            held = main_line.at((e1 + s2) / 2)[0] if main_line else None
            gaps.append({"start_s": (e1 - t0) / 1e6,
                         "ms": (s2 - e1) / 1e3,
                         "main_thread": held or "outside"})
    span = (t1 - t0) / 1e6
    busy_s = sum(b - a for a, b in busy) / 1e6
    report: Dict[str, Any] = {
        "meta": meta, "span_seconds": span, "device_busy_seconds": busy_s,
        "busy_share": busy_s / span if span else None,
        "family_seconds": dict(sorted(family_s.items(),
                                      key=lambda kv: -kv[1])),
        "family_seconds_by_thread": {t: dict(v) for t, v in threads.items()},
        "top_ops": [{"family": f, "op": o, "seconds": s} for (f, o), s in
                    sorted(ops.items(), key=lambda kv: -kv[1])[:20]],
        "gaps": {"count": len(gaps),
                 "seconds": sum(g["ms"] for g in gaps) / 1e3,
                 "largest": sorted(gaps, key=lambda g: -g["ms"])[:12]},
    }
    # batch periods: execute start to the next one, on the main thread
    starts = sorted(ts for ts, _, tid, n in trace["stages"]
                    if n == "execute" and tid == main)
    host = meta.get("batch_starts_host") or []
    rows = []
    for k in range(1, len(starts) - 1):
        lo, hi = starts[k], starts[k + 1]
        seg = _segments(events, lo, hi)
        row = {"batch": k, "wall_seconds": (hi - lo) / 1e6,
               **{f: seg.get(f, 0.0) / 1e6 for f in FAMILIES + ("idle",)}}
        row["table_sum_seconds"] = sum(row[f] for f in FAMILIES + ("idle",))
        if len(host) == len(starts):
            row["host_wall_seconds"] = host[k + 1] - host[k]
        row["main_thread"] = _main_thread_split(main_line, lo, hi)
        rows.append(row)
    if rows:
        n = len(rows)
        mean = {k: sum(r[k] for r in rows) / n for k in rows[0]
                if k not in ("batch", "main_thread")}
        mean["main_thread"] = {k: sum(r["main_thread"][k] for r in rows) / n
                               for k in rows[0]["main_thread"]}
        copies = mean["copy H2D"] + mean["copy D2H"]
        report["steady"] = {
            "batches": rows, "mean": mean,
            "busy_share": 1.0 - mean["idle"] / mean["wall_seconds"],
            "copies_share": copies / mean["wall_seconds"],
        }
    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        (Path(out_dir) / "report.json").write_text(json.dumps(report,
                                                              indent=1))
    return report


def _main_thread_split(line: Optional[_Timeline], lo: float,
                       hi: float) -> Dict[str, float]:
    """Seconds of [lo, hi) by the main thread's innermost stage (init,
    fit, the rest of execute) and outside any stage (the main thread waits
    for a prepared batch or a finalize slot); they sum to hi - lo."""
    out = {"init": 0.0, "fit": 0.0, "execute": 0.0, "outside": 0.0}
    bounds = [lo] + ([b for b in line.bounds if lo < b < hi]
                     if line else []) + [hi]
    for a, b in zip(bounds, bounds[1:]):
        stage = line.at((a + b) / 2)[0] if line else None
        out[stage if stage in out else "outside"] += (b - a) / 1e6
    return out


def print_report(report: Dict[str, Any]) -> None:
    print(f"span {report['span_seconds']:.3f} s, device busy "
          f"{report['device_busy_seconds']:.3f} s "
          f"(share {report['busy_share']:.4f})")
    print("device seconds by family: " + ", ".join(
        f"{k} {v:.4f}" for k, v in report["family_seconds"].items()))
    print(f"queue gaps of 1 ms or more: {report['gaps']['count']}, "
          f"{report['gaps']['seconds']:.3f} s")
    st = report.get("steady")
    if st:
        cols = ("wall_seconds",) + FAMILIES + ("idle", "table_sum_seconds")
        print("| batch | " + " | ".join(cols) + " | host wall |")
        print("|---" * (len(cols) + 2) + "|")
        for r in st["batches"] + [dict(st["mean"], batch="mean")]:
            print(f"| {r['batch']} | " + " | ".join(
                f"{r[c]:.4f}" for c in cols) + " | "
                + (f"{r['host_wall_seconds']:.4f}"
                   if "host_wall_seconds" in r else "") + " |")
        print(f"steady busy share {st['busy_share']:.4f}, host-device "
              f"copies {100 * st['copies_share']:.2f} % of the batch wall")
        print("the main thread's seconds a batch by stage: " + ", ".join(
            f"{k} {v:.4f}" for k, v in st["mean"]["main_thread"].items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["capture", "analyze", "both"])
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--no-ops", dest="ops", action="store_false",
                    help="record the CUDA activities alone (a smaller, "
                    "faster trace; no op names)")
    args = ap.parse_args(argv)
    if args.mode in ("capture", "both"):
        import torch
        if not torch.cuda.is_available():
            print("trace_steady_state: capture needs a CUDA device",
                  file=sys.stderr)
            return 2
        capture(args.out, args.batches, args.lanes, args.epochs,
                ops=args.ops)
    if args.mode in ("analyze", "both"):
        print_report(analyze(args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
