"""`st_dadk_tpu_torch/trace_steady_state.py`'s analysis, on a small trace
in torch.profiler's Chrome format (the capture runs on the card:
chip_smoke.py phase 31).

The fixture: four batches 100 ms apart on the main thread (tid 1), each an
'execute' stage holding 'init' and 'fit', and the previous batch's
'finalize' on a thread of its own (tid 2); the backward's kernels launched
from autograd's thread (tid 3, no stage). A batch period's device time:
H2D copy 1 ms, init 4, fit 18 + 30, eval/finalize 6, D2H copy 0.5, idle
40.5. Each case runs on the trace with every thread's stages; on the trace
as the profiler records it with CPU ops (the main thread's ranges only)
with every stage also given on a host clock 5 ms off the trace's; and on
the trace of CUDA activities alone (no range, no op, every launching thread
under another id than the host's), the stages on the host clock of the
trace's base time."""
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
        ev += [_x("user_annotation", "stage:execute", b, 80, 7, 1),
               _x("user_annotation", "stage:init", b, 10, 7, 1),
               _x("user_annotation", "stage:fit", b + 10, 70, 7, 1),
               _x("cpu_op", "aten::copy_", b + 0.1, 0.3, 7, 1),
               _x("cpu_op", "aten::addmm", b + 11.5, 1, 7, 1)]
        launch(1, b + 0.2, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)",
               b + 0.5, 1)
        launch(1, b + 1, "kernel", "gmm_em_kernel", b + 2, 4)
        launch(1, b + 12, "kernel", "fwd_kernel", b + 12, 18)
        launch(3, b + 40, "kernel", "bwd_w_kernel", b + 40, 30)
        if k:
            ev.append(_x("user_annotation", "stage:finalize", b + 20, 20, 7,
                         2))
            launch(2, b + 25, "kernel", "metrics_kernel", b + 72, 6)
            launch(2, b + 26, "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
                   b + 79, 0.5)
    ev.append({"ph": "M", "name": "process_name", "pid": 0,
               "args": {"name": "GPU 0"}})
    return {"traceEvents": ev}


HOST_OFFSET_US = 5 * MS


def _host_spans(trace):
    """The stages of the trace on a host clock HOST_OFFSET_US behind, in
    nanoseconds, as `staged_engine` records them."""
    return [(e["tid"], e["name"][len(tts.STAGE_PREFIX):],
             int((e["ts"] - HOST_OFFSET_US) * 1e3),
             int((e["ts"] + e["dur"] - HOST_OFFSET_US) * 1e3))
            for e in trace["traceEvents"] if e.get("cat") == "user_annotation"]


BASE_NS = 1_700_000_000 * 10 ** 9


@pytest.fixture(params=["every thread traced", "host spans", "CUDA alone"])
def report(tmp_path, request):
    raw = _fixture()
    if request.param == "host spans":
        spans = _host_spans(raw)
        raw["traceEvents"] = [e for e in raw["traceEvents"]
                              if e.get("cat") != "user_annotation"
                              or e["tid"] == 1]
        trace = tts.compact(raw, spans)
    elif request.param == "CUDA alone":
        spans = [(tid, name, int(t0 + HOST_OFFSET_US * 1e3 + BASE_NS),
                  int(t1 + HOST_OFFSET_US * 1e3 + BASE_NS))
                 for tid, name, t0, t1 in _host_spans(raw)]
        raw["baseTimeNanoseconds"] = BASE_NS
        raw["traceEvents"] = [
            dict(e, tid=1000 + e["tid"]) if e.get("cat") == "cuda_runtime"
            else e for e in raw["traceEvents"]
            if e.get("cat") not in ("user_annotation", "cpu_op")]
        trace = tts.compact(raw, spans)
    else:
        trace = tts.compact(raw)
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
        # (a host clock in nanoseconds from 1.7e18 rounds to 0.25 us)
        assert r["main_thread"] == pytest.approx(
            {"init": 10e-3, "fit": 70e-3, "execute": 0.0, "outside": 20e-3},
            abs=1e-6)
    assert st["batches"][0]["host_wall_seconds"] == pytest.approx(0.0996)
    assert st["copies_share"] == pytest.approx(1.5e-2)
    assert st["busy_share"] == pytest.approx(0.595)
    assert json.loads((tmp_path / "report.json").read_text())["steady"]
    tts.print_report(report)
