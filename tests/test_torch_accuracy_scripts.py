"""The accuracy scripts of the competition path and the CPU vector-math
probe, on the CPU at toy sizes (numpy data; no fit):

  - scripts/port_accuracy_competition.py `compare` takes a run of
    scripts/port_accuracy_paired.py (submissions only, no `pipeline` key)
    beside full runs and puts it in the submission tables alone;
  - scripts/port_accuracy_paired.py: the dropout-0 config, the flat/nested
    params round trip of its init files, the first epoch past a gap, and
    its compare table;
  - scripts/port_vml_probe.py runs one fresh process a variant and reports
    each call.
Exact comparisons throughout (the scripts copy numbers, they compute none
but means, stds and gaps)."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row(seed, rmse, pipeline=None, history=None):
    row = {"seed": seed, "rmse": rmse, "mae": rmse / 2,
           "persistence_rmse": 1.5, "persistence_mae": 1.2}
    if pipeline:
        row["pipeline"] = pipeline
    if history is not None:
        row["history"] = {"val_loss": history}
    return row


def _run(d, rows, info):
    d.mkdir(parents=True)
    (d / "scores.json").write_text(json.dumps(rows))
    (d / "run_info.json").write_text(json.dumps(info))
    return d


def test_competition_compare_takes_a_paired_run(tmp_path):
    comp = _script("port_accuracy_competition")
    full = [_row(s, r, p) for s, r in ((1, 1.0), (2, 1.2))
            for p in ("submission", "forecast")]
    jax = _run(tmp_path / "jax", full, {"n": 2, "hardware": "CPU host",
                                        "wall_seconds": 3.0})
    paired = _run(tmp_path / "paired", [_row(1, 1.4), _row(2, 1.6)],
                  {"hardware": "card"})
    text = comp.compare([f"jax={jax}", f"paired={paired}"], None)
    sub, fc = text.split("| forecast rmse by seed")
    assert "| submission rmse by seed | jax | paired | persistence |" in sub
    assert "| 1 | 1.0 | 1.4 | 1.5 |" in sub
    assert "| mean | 1.1 | 1.5 | |" in sub
    assert "paired" not in fc.split("sigma_mean =")[0]
    assert "- `paired`: 2 seeds on card" in text


def test_paired_config_and_init_round_trip(tmp_path):
    paired = _script("port_accuracy_paired")
    cfg = tmp_path / "c.yaml"
    cfg.write_text("tag: x\ndropout: 0.1\nepochs: 500\nlr: 2e-2\n")
    out = paired.paired_config(cfg, tmp_path, epochs=7)
    assert out.read_text() == "tag: x\ndropout: 0.0\nepochs: 7\nlr: 2e-2\n"
    assert paired.paired_config(cfg, tmp_path).read_text() == (
        "tag: x\ndropout: 0.0\nepochs: 500\nlr: 2e-2\n")
    rng = np.random.default_rng(0)
    tree = {"basis": {"centers": rng.normal(size=(3, 2)).astype(np.float32)},
            "mlp": {"linear_0": {"w": rng.normal(size=(4, 2)).astype(
                np.float32)}, "delta": None}}
    flat = paired._flat(tree)
    assert sorted(flat) == ["basis/centers", "mlp/linear_0/w"]
    back = paired._nest(flat)
    np.testing.assert_array_equal(back["basis"]["centers"],
                                  tree["basis"]["centers"])
    np.testing.assert_array_equal(back["mlp"]["linear_0"]["w"],
                                  tree["mlp"]["linear_0"]["w"])


@pytest.mark.parametrize("gap, want", [(1e-4, 2), (1e-2, 3), (1.0, None)])
def test_paired_first_past(gap, want):
    paired = _script("port_accuracy_paired")
    ref = [1.0, 1.0, 1.0, 1.0]
    got = [1.0, 1.0 + 5e-4, 1.0 + 5e-2, 1.5]
    assert paired.first_past(got, ref, gap) == want


def test_paired_compare_table(tmp_path):
    paired = _script("port_accuracy_paired")
    hist = [0.3, 0.2, 0.1]
    jax = _run(tmp_path / "jax", [_row(1, 1.5, history=hist)], {})
    port = _run(tmp_path / "torch",
                [_row(1, 1.25, history=[0.3, 0.2004, 0.2])], {})
    text = paired.compare([f"jax={jax}", f"torch={port}"], None)
    assert "| 1 | 1.5 | 0.75 | 1.25 | 0.625 | 2, 2, 3 | -0.250000 |" in text


def test_vml_probe_runs_a_process_a_variant(tmp_path, capsys):
    probe = _script("port_vml_probe")
    assert probe.main(["--processes", "1", "--workers", "2", "--variants",
                       "f32_sqrt", "warm_sqrt", "--out",
                       str(tmp_path / "p.json")]) == 0
    res = json.loads((tmp_path / "p.json").read_text())
    calls = {v: e["calls"] for v, e in res["variants"].items()}
    assert calls["f32_sqrt"].keys() == {"f32_sqrt_call0", "f32_sqrt_call1"}
    assert [n for _, n in calls["f32_sqrt"].values()] == [1, 1]
    assert calls["warm_sqrt"]["f32_sqrt_after_warm"][1] == 1
    assert "wrong in" in capsys.readouterr().out
