"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
in a temporary directory, cut to a toy size, that the harness runs on the
CPU with the program's plain versions of its kernels.

    python -m pytest stbench/tests -q -p no:cacheprovider

Tests marked `chip` need the card and skip without it (they decide inside
the test); on the card they run with the same command.
"""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TOY_PROGRAM = dict(k_spatial_centers=[4, 9], k_temporal_centers=[5],
                   hidden_dims=[16, 8], epochs=3, eval_chunk=1024)
TOY_FIELD = dict(sites=60, times=12)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skips without one")


def make_toy(dst: Path) -> Path:
    """A copy of stbench/ and BENCHMARK.json under `dst`, every
    configuration and traffic mix cut to a toy size: the package dir."""
    import torch
    torch.set_num_threads(2)
    pkg = dst / "stbench"
    shutil.copytree(REPO / "stbench", pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for f in (pkg / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["program"].update(TOY_PROGRAM)
        c["field"].update(TOY_FIELD)
        f.write_text(json.dumps(c))
    for f in (pkg / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        if t["driver"] == "train_batches":
            t.update(lanes=3, warm_epochs=1,
                     trace={"batch": 0, "after_epochs": 1, "epochs": 1})
        else:
            t.update(points=5000, point_sets=2, warm_requests=1,
                     sample_from=3, sample_requests=2,
                     trace={"after_requests": 1, "requests": 2})
        f.write_text(json.dumps(t))
    return pkg


@pytest.fixture
def toy(tmp_path):
    from stbench.run import Layout
    return Layout(make_toy(tmp_path))


@pytest.fixture
def run_toy(toy, monkeypatch, tmp_path):
    """run_toy(workload, seconds=0.3, trace=False, readings=False) -> the
    result dict of one CPU run of the toy cell."""
    from stbench.run import run_cell
    monkeypatch.setenv("TMPDIR", str(tmp_path))

    def go(workload, seconds=0.3, trace=False, readings=False, seed=4242):
        return run_cell(toy, workload, seed, seconds, trace, "cpu",
                        time.perf_counter(), readings=readings)
    return go
