"""`st_dadk_tpu_torch/trace_steady_state.py`'s analysis, on a small trace
in torch.profiler's Chrome format (the capture runs on the card:
chip_smoke.py phase 31).

The fixture: four batches 100 ms apart on the main thread (tid 1), each a
'batch.execute' span holding 'batch.init' and 'fit', and the previous
batch's 'batch.finalize' on a thread of its own (tid 2); the backward's
kernels launched from autograd's thread (tid 3, no span). A batch period's
device time: H2D copy 1 ms, init 4, fit 18 + 30, eval/finalize 6, D2H copy
0.5, idle 40.5. The stages are the program's spans, as the tracer drains
them (`utils/trace.py`: native thread ids, stamps on `time.time_ns()`'s
clock). Each case runs on the trace as the profiler records it with CPU ops
(launching threads under their native ids), with no base time (an older
torch's trace counts from 0) or with an epoch base time; and on the trace
of CUDA activities alone (no op, every launching thread under another id
than its native one), on the epoch base time."""
import gzip
import json

import pytest

from st_dadk_tpu_torch import trace_steady_state as tts

MS = 1000.0                      # the trace's microseconds a millisecond
PERIOD = 100.0


def _x(cat, name, ts, dur, pid, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts * MS,
            "dur": dur * MS, "pid": pid, "tid": tid, "args": args}


def _fixture():
    ev, corr = [], [0]

    def launch(tid, at, cat, name, start, dur):
        corr[0] += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", at, 0.01, 7, tid,
                     correlation=corr[0]))
        ev.append(_x(cat, name, start, dur, 0, 7, correlation=corr[0],
                     stream=7))

    for k in range(4):
        b = k * PERIOD
        ev += [_x("cpu_op", "aten::copy_", b + 0.1, 0.3, 7, 1),
               _x("cpu_op", "aten::addmm", b + 11.5, 1, 7, 1)]
        launch(1, b + 0.2, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)",
               b + 0.5, 1)
        launch(1, b + 1, "kernel", "gmm_em_kernel", b + 2, 4)
        launch(1, b + 12, "kernel", "fwd_kernel", b + 12, 18)
        launch(3, b + 40, "kernel", "bwd_w_kernel", b + 40, 30)
        if k:
            launch(2, b + 25, "kernel", "metrics_kernel", b + 72, 6)
            launch(2, b + 26, "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
                   b + 79, 0.5)
    ev.append({"ph": "M", "name": "process_name", "pid": 0,
               "args": {"name": "GPU 0"}})
    return {"traceEvents": ev}


def _program(base_ns):
    """The engine's spans of the fixture, as `trace.drain()` gives them:
    (thread, name, start ms, length ms) on a clock `base_ns` behind the
    trace's zero."""
    rows = []
    for k in range(4):
        b = k * PERIOD
        rows += [(1, "batch.execute", b, 80), (1, "batch.init", b, 10),
                 (1, "fit", b + 10, 70)]
        if k:
            rows.append((2, "batch.finalize", b + 20, 20))
    return {"spans": [{"name": name, "thread": tid, "ids": {"batch": i},
                       "start_ns": base_ns + int(start * 1e6),
                       "end_ns": base_ns + int((start + dur) * 1e6),
                       "id": i, "parent": None}
                      for i, (tid, name, start, dur) in enumerate(rows)]}


BASE_NS = 1_700_000_000 * 10 ** 9


@pytest.fixture(params=["CPU ops", "epoch clock", "CUDA alone"])
def report(tmp_path, request):
    raw = _fixture()
    base = 0 if request.param == "CPU ops" else BASE_NS
    if base:
        raw["baseTimeNanoseconds"] = base
    if request.param == "CUDA alone":
        raw["traceEvents"] = [
            dict(e, tid=1000 + e["tid"]) if e.get("cat") == "cuda_runtime"
            else e for e in raw["traceEvents"] if e.get("cat") != "cpu_op"]
    trace = tts.compact(raw, _program(base))
    with gzip.open(tmp_path / "trace.json.gz", "wt") as f:
        json.dump(trace, f)
    meta = {"batch_starts_host": [0.0, 0.1004, 0.2, 0.3001]}
    (tmp_path / "capture_meta.json").write_text(json.dumps(meta))
    return tts.analyze(tmp_path), request.param


def test_families_by_the_launching_thread(report):
    report, mode = report
    fam = report["family_seconds"]
    assert fam["fit step"] == pytest.approx(4 * 48e-3)       # autograd's too
    assert fam["init"] == pytest.approx(4 * 4e-3)
    assert fam["eval/finalize"] == pytest.approx(3 * 6e-3)
    assert fam["copy H2D"] == pytest.approx(4 * 1e-3)
    assert fam["copy D2H"] == pytest.approx(3 * 0.5e-3)
    assert "other" not in fam
    ops = {(r["family"], r["op"]) for r in report["top_ops"]}
    assert ("fit step", "fwd_kernel" if mode == "CUDA alone"
            else "aten::addmm") in ops
    assert ("fit step", "bwd_w_kernel") in ops      # no op around it


def test_gaps_and_busy_share(report):
    report, _ = report
    assert report["span_seconds"] == pytest.approx(0.379)
    assert report["busy_share"] == pytest.approx(
        report["device_busy_seconds"] / report["span_seconds"])
    largest = report["gaps"]["largest"]
    assert largest[0]["ms"] == pytest.approx(30.5)     # batch 0: no finalize
    assert {g["main_thread"] for g in largest} >= {"fit", "outside"}
    assert all(g["ms"] >= 1.0 for g in largest)
    # the idle time, 147.5 ms, by each thread's innermost span: the main
    # thread's init holds the first idle of each batch, its fit the gaps
    # between the step's kernels, the wait for a batch 20 ms a period;
    # the finalize thread's span 10 ms of each of its three batches
    by_span = report["idle_by_span"]
    assert by_span["main"] == pytest.approx(
        {"fit": 68e-3, "outside": 60e-3, "batch.init": 19.5e-3}, abs=1e-6)
    assert by_span["finalize"] == pytest.approx(
        {"batch.finalize": 30e-3, "outside": 117.5e-3}, abs=1e-6)


def test_steady_table_sums_to_the_batch_wall(report, tmp_path):
    report, _ = report
    st = report["steady"]
    assert [r["batch"] for r in st["batches"]] == [1, 2]
    for r in st["batches"]:
        assert r["wall_seconds"] == pytest.approx(0.1)
        assert r["table_sum_seconds"] == pytest.approx(r["wall_seconds"])
        assert r["idle"] == pytest.approx(40.5e-3)
        assert r["fit step"] == pytest.approx(48e-3)
        # the main thread: init 10 ms, fit 70, waiting 20, summing to 0.1 s
        # (a clock in nanoseconds from 1.7e18 rounds to 0.25 us)
        assert r["main_thread"] == pytest.approx(
            {"init": 10e-3, "fit": 70e-3, "execute": 0.0, "outside": 20e-3},
            abs=1e-6)
    assert st["batches"][0]["host_wall_seconds"] == pytest.approx(0.0996)
    assert st["copies_share"] == pytest.approx(1.5e-2)
    assert st["busy_share"] == pytest.approx(0.595)
    assert json.loads((tmp_path / "report.json").read_text())["steady"]
    tts.print_report(report)
