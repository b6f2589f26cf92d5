"""The harness finds every cell's files by name, and BENCHMARK.json keeps
to the shape its readers expect."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_to_its_files():
    from stbench.run import Layout
    lay = Layout()
    bench = lay.bench()
    for cell in bench["workloads"]:
        found = lay.cell(cell["name"])
        assert callable(found["driver"].run)
        assert found["config"]["program"]["epochs"] == 50
    for m in bench["per_layer"]:
        assert callable(lay.module("metrics", m["name"]).read)


def test_benchmark_json_names_and_links():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    configs = {c["name"] for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    names = [c["name"] for c in bench["configs"]] + list(cells) + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert 0 < len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        traffic = REPO / "stbench" / "traffic" / f"{w['traffic']}.json"
        assert traffic.is_file()
        assert 0 < len(w["why"]) <= 200
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            moved = next(e for e in bench["end_to_end"]
                         if e["name"] == m["moves"])
            assert w in moved.get("workloads", cells)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert "lane engine" in layers and "kernels" in layers
    for w in cells:
        assert any(w in m.get("workloads", cells)
                   for m in bench["per_layer"])
        assert any(m["name"] != "setup_s" and w in m.get("workloads", cells)
                   for m in bench["end_to_end"])


def test_a_new_cell_is_found_with_no_edit(tmp_path):
    """A throwaway configuration, traffic mix, driver and metric added in
    a copy are found by name; no file that exists changes."""
    from stbench.run import Layout
    pkg = tmp_path / "stbench"
    shutil.copytree(REPO / "stbench", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (pkg / "configs" / "toy_cfg.json").write_text(json.dumps(
        {"program": {"epochs": 1}, "field": {}}))
    (pkg / "traffic" / "toy_mix.json").write_text(json.dumps(
        {"driver": "toy_driver", "limits": {}}))
    (pkg / "drivers" / "toy_driver.py").write_text(
        "def run(ctx):\n    return {'toy': ctx}\n")
    (pkg / "metrics" / "toy.metric.py").write_text(
        "def read(obs):\n    return obs.get('toy')\n")
    bench["configs"].append({"name": "toy_cfg", "source": "x",
                             "file": "stbench/configs/toy_cfg.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "toy_cfg.toy_mix", "config": "toy_cfg",
                               "traffic": "toy_mix", "chips": 1, "why": "t"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    lay = Layout(pkg)
    found = lay.cell("toy_cfg.toy_mix")
    assert found["config"]["program"] == {"epochs": 1}
    assert found["driver"].run(7) == {"toy": 7}
    assert lay.module("metrics", "toy.metric").read({"toy": 3.5}) == 3.5
    assert all(p.read_bytes() == b for p, b in before.items())


def test_an_unknown_cell_is_refused():
    from stbench.run import Layout
    with pytest.raises(KeyError):
        Layout().cell("no_such.cell")
