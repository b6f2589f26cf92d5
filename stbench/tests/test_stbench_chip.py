"""The command itself on the card: a short run of the predict cell prints
its result as the last line, correct, with the card's name and its peak
memory. Skips without a CUDA device (decided inside the test).

    python -m pytest stbench/tests -q -p no:cacheprovider -m chip
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.mark.chip
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "stbench", "--workload",
         "dastdk_bench.predict1m", "--seed", "2147483701", "--seconds", "3",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    assert res["device"]["memory_peak_bytes"] > 0
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(res["metrics"]) == {
        m["name"] for m in bench["end_to_end"]
        if "dastdk_bench.predict1m" in m.get("workloads", [
            "dastdk_bench.predict1m"])}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def test_without_a_card_the_command_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "stbench", "--workload",
         "stdk_bench.train128", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
