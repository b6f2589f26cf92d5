"""The port's tracer (`st_dadk_tpu_torch/utils/trace.py`) on the CPU: off,
a batch stream records nothing and keeps its `stage_timings`; on, the batch
pipeline, the lane engine and predict record their spans with ids, threads
and parents, one host read an epoch, and the drained stamps lie on
`time.time_ns()`'s clock. `trace_steady_state`'s reading of a record: the
device's idle time by each thread's innermost span. The kernels' launch
counter (`ops/_launch.py::LaunchCounter`), driven through `_count` (the CPU
launches no kernel), gives what the per-kernel totals and shape sets
gave."""
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from st_dadk_tpu_torch import trace_steady_state as tts
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.models.st_interp import init_model, spec_from_config
from st_dadk_tpu_torch.ops import fused_first_layer as ffl
from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
from st_dadk_tpu_torch.train import batch_engine as tbe
from st_dadk_tpu_torch.train.loop import predict
from st_dadk_tpu_torch.utils import trace
from torch_threads import worker_threads  # noqa: F401

EPOCHS, LANES, BATCHES = 2, 2, 2
STAGE_KEYS = {
    "batch_eval_seconds", "batch_finalize_seconds", "batch_init_seconds",
    "batch_lanes", "batch_prepare_seconds", "batch_setup_seconds",
    "batch_train_seconds", "data_seconds", "epochs_run_batch",
    "epochs_seconds", "eval_seconds", "first_epoch_seconds", "init_seconds",
    "setup_seconds", "steps_per_epoch_batch", "train_seconds"}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and drained."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _cfg(tmp_path, **kw):
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (tmp_path / "toy.csv").write_text("\n".join(lines))
    return ExperimentConfig.from_dict(dict(
        tag="trace", k_spatial_centers=[9], k_temporal_centers=[4],
        hidden_dims=[16, 8], dropout=0.0, epochs=EPOCHS, batch_size=64,
        data_file=str(tmp_path / "toy.csv"), device="cpu", base_seed=100,
        save_artifacts=False, save_plots=False, **kw))


def _stream(tmp_path):
    cfg = _cfg(tmp_path)
    jobs = [(cfg, i, tmp_path / "e" / str(i))
            for i in range(1, LANES * BATCHES + 1)]
    batches = [jobs[i:i + LANES] for i in range(0, len(jobs), LANES)]
    return tbe.run_job_batches(batches, device="cpu")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A stream of BATCHES batches of LANES lanes, EPOCHS epochs, traced:
    (results, the drained record, the main thread's native id)."""
    trace.enable()
    try:
        results = _stream(tmp_path_factory.mktemp("traced"))
    finally:
        trace.disable()
    return results, trace.drain(), threading.get_native_id()


def _by_name(rec):
    out = {}
    for s in rec["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_keeps_the_stage_timings(tmp_path):
    results = _stream(tmp_path)
    assert len(results) == LANES * BATCHES
    for r in results:
        assert set(r["stage_timings"]) == STAGE_KEYS
        assert r["stage_timings"]["batch_init_seconds"] > 0.0
    rec = trace.drain()
    assert rec["spans"] == []
    assert trace.span("fit.step") is trace.span("predict.request")


@pytest.mark.parametrize("stage, thread", [
    ("batch.prepare", "other"), ("batch.wait_prepare", "main"),
    ("batch.execute", "main"), ("batch.finalize", "other"),
    ("batch.wait_finalize", "main")])
def test_each_batch_has_its_stages_on_their_threads(traced, stage, thread):
    _, rec, main = traced
    spans = _by_name(rec)[stage]
    assert sorted(s["ids"]["batch"] for s in spans) == \
        sorted({s["ids"]["batch"] for s in _by_name(rec)["batch.execute"]})
    assert len(spans) == BATCHES
    assert all((s["thread"] == main) == (thread == "main") for s in spans)
    assert all(s["parent"] is None for s in spans)


@pytest.mark.parametrize("child, parent", [
    ("batch.upload", "batch.execute"), ("batch.init", "batch.execute"),
    ("fit", "batch.execute"), ("init.centers", "batch.init"),
    ("init.models", "batch.init"), ("fit.epoch", "fit"),
    ("fit.shuffle", "fit.epoch"), ("fit.step", "fit.epoch"),
    ("fit.validate", "fit.epoch"), ("fit.bookkeeping", "fit.epoch"),
    ("fit.host_read", "fit.bookkeeping"),
    ("finalize.eval", "batch.finalize"), ("finalize.write", "batch.finalize")])
def test_spans_nest_in_their_parents(traced, child, parent):
    _, rec, _ = traced
    by_id = {s["id"]: s for s in rec["spans"]}
    kids = _by_name(rec)[child]
    assert kids
    for s in kids:
        up = by_id[s["parent"]]
        assert up["name"] == parent and up["thread"] == s["thread"]
        assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] <= up["end_ns"]
        assert s["ids"]["batch"] == up["ids"]["batch"]


def test_steps_and_their_three_children(traced):
    _, rec, _ = traced
    spans = _by_name(rec)
    B = traced[0][0]["stage_timings"]["steps_per_epoch_batch"]
    assert len(spans["fit.epoch"]) == EPOCHS * BATCHES
    assert len(spans["fit.step"]) == EPOCHS * BATCHES * B
    kids = Counter((s["parent"], s["name"]) for s in rec["spans"]
                   if s["name"].startswith("step."))
    for step in spans["fit.step"]:
        for name in ("step.forward", "step.backward", "step.optimizer"):
            assert kids[(step["id"], name)] == 1
    epochs = Counter((s["ids"]["batch"], s["ids"]["epoch"])
                     for s in spans["fit.step"])
    assert set(epochs.values()) == {B}


def test_host_reads_are_the_epochs_run(traced):
    results, rec, main = traced
    reads = _by_name(rec)["fit.host_read"]
    per_batch = {r["stage_timings"]["epochs_run_batch"] for r in results}
    assert len(reads) == BATCHES * per_batch.pop() == EPOCHS * BATCHES
    assert {s["thread"] for s in reads} == {main}


@pytest.mark.parametrize("lanes", [None, 2])
def test_a_predict_request_and_its_chunks(tmp_path, lanes):
    cfg = _cfg(tmp_path)
    model = init_model(torch.Generator().manual_seed(0),
                       spec_from_config(cfg), device="cpu").eval()
    rng = np.random.default_rng(1)
    n, chunk = 250, 100
    coords = rng.random((n, 2), dtype=np.float32)
    t = rng.random(n, dtype=np.float32)
    trace.enable()
    if lanes is None:
        out = predict(model, coords, t, chunk)
    else:
        from st_dadk_tpu_torch.models.st_interp import stack_lane_models
        from st_dadk_tpu_torch.train.loop import predict_lanes
        out = predict_lanes(stack_lane_models([model] * lanes), coords, t,
                            chunk)
    trace.disable()
    rec = trace.drain()
    spans = _by_name(rec)
    (req,) = spans["predict.request"]
    assert [len(spans[k]) for k in ("predict.copy_in", "predict.forward",
                                    "predict.gather")] == [3, 3, 1]
    for name in ("predict.copy_in", "predict.forward", "predict.gather"):
        for s in spans[name]:
            assert s["parent"] == req["id"]
            assert s["ids"] == req["ids"] == {"request": req["ids"]["request"]}
    assert out.shape[:-1] == ((n,) if lanes is None else (lanes, n))


def test_stamps_are_on_the_wall_clock():
    trace.enable()
    with trace.span("outer", request=7):
        inside = time.time_ns()
        with trace.span("inner"):
            pass
    trace.disable()
    rec = trace.drain()
    outer = next(s for s in rec["spans"] if s["name"] == "outer")
    inner = next(s for s in rec["spans"] if s["name"] == "inner")
    assert outer["start_ns"] - 1_000_000 <= inside <= outer["end_ns"] + \
        1_000_000
    assert abs(inside - outer["start_ns"]) < 1_000_000
    assert inner["parent"] == outer["id"] and inner["ids"] == {"request": 7}
    assert rec["on_ns"] <= outer["start_ns"] <= outer["end_ns"] <= \
        rec["off_ns"]
    assert rec["thread"] == outer["thread"] == threading.get_native_id()


def test_a_stage_stamps_while_off_and_records_nothing():
    with trace.stage("batch.execute", batch=3) as stage:
        time.sleep(0.002)
        with trace.span("fit"):
            pass
    assert stage.seconds >= 0.002
    assert stage.t0 < stage.t1
    assert trace.drain()["spans"] == []


# --- the trace tool's reading: idle by innermost span ----------------------

def _read(spans, busy, thread=1):
    """`idle_by_span` of (start, end, name) spans in ms on one thread
    holding 'fit' (the main thread) and device `busy` intervals in ms, as
    seconds."""
    tr = {"spans": [(a * 1e3, (b - a) * 1e3, thread, n)
                    for a, b, n in spans + [(0.0, 0.0, "fit")]]}
    return tts.idle_by_span(tr, [[a * 1e3, b * 1e3] for a, b in busy])["main"]


@pytest.mark.parametrize("spans, busy, want", [
    # idle inside one span
    ([(0, 10, "fit.step")], [(0, 2), (5, 10)], {"fit.step": 3e-3}),
    # outside every span
    ([(0, 4, "fit.step")], [(0, 4), (6, 8)], {"outside": 2e-3}),
    # across a child, its parent and no span
    ([(0, 10, "fit.step"), (2, 6, "step.optimizer")], [(0, 1), (12, 13)],
     {"step.optimizer": 4e-3, "fit.step": 5e-3, "outside": 2e-3}),
    # no idle at all reads zero
    ([(0, 10, "fit.step")], [(0, 4), (4, 10)], {"outside": 0.0}),
], ids=["inside", "outside", "across", "none"])
def test_idle_goes_to_the_innermost_span(spans, busy, want):
    got = {k: v for k, v in _read(spans, busy).items()
           if abs(v) > 1e-12 or k in want}
    assert got == pytest.approx(want, abs=1e-12)
    assert sum(_read(spans, busy).values()) == pytest.approx(
        sum(b - a for (_, a), (b, _) in zip(busy, busy[1:])) * 1e-3)


def test_nested_spans_cut_into_stretches():
    rows = [(0, 10, "a"), (2, 4, "b"), (4, 6, "c"), (5, 6, "d"), (12, 13, "e")]
    assert tts._stretches(rows) == [
        (0, 2, ("a",)), (2, 4, ("a", "b")), (4, 5, ("a", "c")),
        (5, 6, ("a", "c", "d")), (6, 10, ("a",)), (12, 13, ("e",))]


# --- the kernels' launch counter -------------------------------------------

_FUSED = [(ffl.fused_first_layer_fwd, (4,), 512, 227, 256, 0),
          (ffl.fused_first_layer_fwd, (4,), 512, 227, 256, 0),
          (ffl.fused_first_layer_fwd, (), 2000, 227, 256, 0),
          (ffl.fused_first_layer_bwd_w, (4,), 512, 227, 256, 0),
          (ffl.fused_first_layer_bwd_points, (), 512, 227, 256, 1)]
_BASIS = [(sbk.spatial_basis_fwd, (3,), 512, 228, torch.ones(3, 228), 0),
          (sbk.spatial_basis_fwd, (3,), 512, 228, None, 0),
          (sbk.spatial_basis_fwd, (3,), 512, 228, None, 0),
          (sbk.spatial_basis_bwd_centers, (), 64, 9, None, 2)]


def _old_views(calls, basis):
    """What `<wrapper>.launches` and `<wrapper>.shapes` held."""
    counts, shapes = Counter(), {}
    for fn, lead, n, k, x, basis_id in calls:
        counts[fn.__name__] += 1
        key = ((lead, n, k, 0, x is not None, basis_id) if basis
               else (lead, n, k, x, False, basis_id))
        shapes.setdefault(fn.__name__, set()).add(key)
    return counts, shapes


@pytest.mark.parametrize("mod, calls", [(ffl, _FUSED), (sbk, _BASIS)],
                         ids=["fused", "basis"])
def test_launch_views_give_the_old_totals_and_shapes(mod, calls):
    mod.reset_launch_counts()
    other = sbk if mod is ffl else ffl
    other_before = other.launch_counts()
    for call in calls:
        mod._count(*call)
    counts, shapes = _old_views(calls, mod is sbk)
    names = [fn.__name__ for fn in mod.KERNEL_WRAPPERS]
    assert mod.launch_counts() == {n: counts[n] for n in names}
    assert mod.launch_shapes() == {n: sorted(shapes.get(n, ()))
                                   for n in names}
    assert other.launch_counts() == other_before
    mod.reset_launch_counts()
    assert set(mod.launch_counts().values()) == {0}


def test_launches_count_whether_the_tracer_is_on_or_off():
    ffl.reset_launch_counts()
    call = (ffl.fused_first_layer_fwd, (2,), 64, 9, 16, 0)
    ffl._count(*call)
    trace.enable()
    ffl._count(*call)
    trace.disable()
    assert ffl.launch_counts()["fused_first_layer_fwd"] == 2
    assert ffl.launch_shapes()["fused_first_layer_fwd"] == [
        ((2,), 64, 9, 16, False, 0)]
    assert trace.drain()["spans"] == []
    ffl.reset_launch_counts()


def test_counters_lose_no_update_across_threads():
    """Threads launch and record spans at once, the interpreter switching
    every microsecond: every launch and every span is kept."""
    ffl.reset_launch_counts()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads, per = 8, 2000
    trace.enable()
    try:
        def work():
            for _ in range(per):
                ffl._count(ffl.fused_first_layer_bwd_w, (), 8, 4, 2, 0)
                with trace.span("fit.step"):
                    pass
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(switch)
        trace.disable()
    rec = trace.drain()
    assert ffl.launch_counts()["fused_first_layer_bwd_w"] == threads * per
    assert len(rec["spans"]) == threads * per
    ffl.reset_launch_counts()
