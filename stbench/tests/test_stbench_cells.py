"""Each cell's run on the CPU at a toy size: it comes out correct, and it
comes out not correct when the program under it is broken, once for each
fault the cell can have, and when the control (the reference with TF32
products) stands in the program's place.

The harness's look for a card is skipped (`run_cell` on the CPU); the
program runs its plain versions of the kernels there.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

TRAIN = ("stdk_bench.train128",)
PREDICT = "dastdk_bench.predict1m"


@pytest.mark.parametrize("cell", TRAIN + (PREDICT,))
def test_a_toy_run_is_correct(toy, run_toy, cell):
    res = run_toy(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    bench = toy.bench()
    want = {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("cell", TRAIN + (PREDICT,))
def test_a_traced_toy_run_reads_its_host_metrics(run_toy, cell):
    res = run_toy(cell, trace=True)
    assert res["correct"], res["checks"]
    names = set(res["metrics"])
    if cell in TRAIN:
        # the device readers find no device trace on the CPU
        assert names == {"lane_step_ms.train", "batch_init_s.train"}
    else:
        assert names == set()
    assert "window_s" in res["device"] and "breakdown" in res


def _limits(cell):
    """The limits of the cell's traffic mix, set at the cell's own size."""
    from stbench.run import Layout
    return Layout().json("traffic", cell.split(".")[1])["limits"]


@pytest.mark.parametrize("cell", TRAIN + (PREDICT,))
def test_the_control_fails_the_cells_limits(run_toy, cell):
    """The reference with TF32 products in the program's place reads past
    a limit of the cell on every lane or request it is compared on."""
    res = run_toy(cell, readings=True)
    limits = _limits(cell)
    assert res["readings"]
    for row in res["readings"]:
        assert any(row.get("control_" + k, 0.0) > limits[k] for k in limits
                   if not k.endswith("mismatch")), row


def _stuck_step(monkeypatch):
    """A step that returns the state unchanged."""
    from st_dadk_tpu_torch.train import optimizer
    monkeypatch.setattr(optimizer.AdamWLanes, "step",
                        lambda self, lrs, executes: None)


def _half_batch(monkeypatch):
    """Half of each minibatch left out, the mean taken over the rest."""
    from st_dadk_tpu_torch.train import loop
    orig = loop.lane_losses_from_preds

    def half(spec, model, preds, y, w, *a, **k):
        w = w.clone()
        w[:, w.shape[1] // 2:] = 0
        return orig(spec, model, preds, y, w, *a, **k)
    monkeypatch.setattr(loop, "lane_losses_from_preds", half)


def _dead_dw(monkeypatch):
    """The fused first layer's weight gradient (the dW kernel) returns
    zeros: one leaf of fourteen left unmoved."""
    from st_dadk_tpu_torch.ops import fused_first_layer as ffl
    orig = ffl.fused_first_layer_bwd_w
    monkeypatch.setattr(ffl, "fused_first_layer_bwd_w",
                        lambda *a: torch.zeros_like(orig(*a)))


def _altered_score(monkeypatch):
    """An answer altered where it is produced: the finalize's scores."""
    from st_dadk_tpu_torch.train import batch_engine
    orig = batch_engine._device_metrics
    monkeypatch.setattr(batch_engine, "_device_metrics",
                        lambda *a, **k: orig(*a, **k) * 1.001)


def _altered_point(monkeypatch):
    """An answer altered where it is produced: one predicted point."""
    from st_dadk_tpu_torch.models import st_interp
    orig = st_interp.STInterp.head

    def head(self, h):
        out = orig(self, h)
        return torch.cat([out[:1] + 0.01, out[1:]])
    monkeypatch.setattr(st_interp.STInterp, "head", head)


def _half_points(monkeypatch):
    """Half of each chunk left out: the program answers for the first half
    and repeats it."""
    from st_dadk_tpu_torch.models import st_interp
    orig = st_interp.STInterp.forward

    def forward(self, coords, t, *a, **k):
        n = coords.shape[0]
        out = orig(self, coords[: (n + 1) // 2], t[: (n + 1) // 2], *a, **k)
        return torch.cat([out, out])[:n]
    monkeypatch.setattr(st_interp.STInterp, "forward", forward)


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [_stuck_step, _half_batch, _dead_dw,
                                   _altered_score])
def test_a_broken_training_path_is_not_correct(run_toy, monkeypatch, cell,
                                               fault):
    fault(monkeypatch)
    res = run_toy(cell)
    assert not res["correct"], res["checks"]


def test_a_dead_dw_reads_high_on_the_worst_leaf(run_toy, monkeypatch):
    """A fault of one leaf (the first layer's weight) reads on the worst
    leaf's numbers far past their limits, whatever the median leaf's do."""
    _dead_dw(monkeypatch)
    checks = run_toy(TRAIN[0])["checks"]
    assert checks["grad_worst_gap"]["value"] > 0.1
    assert checks["change_worst_gap"]["value"] > checks["change_worst_gap"][
        "limit"]


def test_a_hook_that_never_fires_is_not_correct(run_toy, monkeypatch):
    """The program stops calling an observed function: the batches are
    not compared, and the run is not correct."""
    from stbench.capture import Capture
    monkeypatch.setattr(Capture, "_validate", lambda self, orig: orig)
    res = run_toy(TRAIN[0])
    assert not res["correct"]
    assert res["checks"]["hooks_missed"]["value"] >= 1


def test_a_traced_run_that_observes_nothing_is_refused(run_toy, monkeypatch):
    """A span that never opens (its hook never fires) makes a traced run
    fail (`stbench.run` exits 5 on the card)."""
    from stbench.capture import Capture
    from stbench.run import trace_faults
    assert trace_faults(run_toy(TRAIN[0], trace=True)) == [
        "per-layer metrics with nothing to read: fused_fwd_roofline.train, "
        "mfu.train, idle_share.train"]
    monkeypatch.setattr(Capture, "_validate", lambda self, orig: orig)
    faults = trace_faults(run_toy(TRAIN[0], trace=True))
    assert faults[0] == "the traced span never opened"


@pytest.mark.parametrize("fault", [_altered_point, _half_points])
def test_a_broken_predict_path_is_not_correct(run_toy, monkeypatch, fault):
    fault(monkeypatch)
    res = run_toy(PREDICT)
    assert not res["correct"], res["checks"]


def test_a_window_drives_every_batch_it_counts(run_toy):
    res = run_toy(TRAIN[0], seconds=0.5, readings=True)
    batches = res["extra"]["batches"]
    assert batches >= 2 and res["attempted"] == 3 * batches
    assert res["checks"]["batches_uncompared"]["value"] == 0
    assert sorted({r["batch"] for r in res["readings"]}) == \
        list(range(batches))
    assert len(res["readings"]) == 2 * batches


def test_seeds_change_the_field_not_the_work(run_toy):
    a = run_toy(PREDICT, seed=1)
    b = run_toy(PREDICT, seed=2 ** 31 + 5)
    assert a["correct"] and b["correct"]
    assert np.isfinite(a["metrics"]["predict_Mpts_per_s"]["value"])
