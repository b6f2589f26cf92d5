"""The run refuses JAX and the JAX package by whole top-level names, and
the reference loads nothing of the program under test."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.mark.parametrize("mods, found", [
    (["st_dadk_tpu_torch", "st_dadk_tpu_torch.train.loop", "numpy"], []),
    (["st_dadk_tpu", "st_dadk_tpu.ops"], ["st_dadk_tpu", "st_dadk_tpu.ops"]),
    (["jax", "jax.numpy", "jaxlib", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib"]),
    (["jaxtyping", "flaxen", "st_dadk_tpu_torchx", "jax_cuda"], []),
])
def test_forbidden_modules_by_whole_top_level_name(mods, found):
    from stbench.run import forbidden_modules
    assert forbidden_modules(mods) == found


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json;"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import stbench.reference.model, stbench.reference.data,"
                   " stbench.reference.train, stbench.standin,"
                   " stbench.yardstick")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"st_dadk_tpu_torch", "st_dadk_tpu", "jax", "jaxlib",
                       "flax"}


def test_a_run_loads_no_jax():
    """Everything a training and a predict run import, the program's
    modules included."""
    mods = _loaded(
        "import stbench.run, stbench.capture, stbench.trace\n"
        "from stbench.run import Layout\n"
        "lay = Layout()\n"
        "for w in lay.bench()['workloads']: lay.cell(w['name'])\n"
        "from st_dadk_tpu_torch.train import batch_engine, loop\n"
        "from st_dadk_tpu_torch.models import st_interp\n"
        "from st_dadk_tpu_torch.config import ExperimentConfig")
    from stbench.run import forbidden_modules
    assert forbidden_modules(mods) == []
    assert "st_dadk_tpu_torch" in mods
