"""The port stands alone: importing every module of st_dadk_tpu_torch pulls
in neither jax, yaml, pandas, matplotlib nor st_dadk_tpu (none of them
exists on the machine with the GPU; the figures import matplotlib inside
their functions)."""
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import st_dadk_tpu_torch
names = [m.name for m in pkgutil.walk_packages(st_dadk_tpu_torch.__path__,
                                               "st_dadk_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "yaml", "pandas",
                                    "st_dadk_tpu", "triton", "matplotlib"))
print(json.dumps({"modules": names, "forbidden": bad}))
"""


def test_port_imports_no_jax_yaml_pandas_or_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "st_dadk_tpu_torch.ops.fused_first_layer" in res["modules"]
    assert "st_dadk_tpu_torch.ops.spatial_basis_kernels" in res["modules"]
    assert "st_dadk_tpu_torch.train.experiment" in res["modules"]
    assert "st_dadk_tpu_torch.train.runner" in res["modules"]
    assert "st_dadk_tpu_torch.train.batch_engine" in res["modules"]
    for name in ("ops.kmeans_exact", "train.checkpoint", "viz.plots",
                 "utils.metrics", "utils.seed", "utils.covariance",
                 "dataio.native", "dataio.windows", "dataio.competition",
                 "models.forecaster", "models.legacy_basis",
                 "cli.predict_submission", "cli.forecast_submission",
                 "cli.score_families", "cli.analyze_table_4_4",
                 "cli.analyze_grid_search", "cli.resume_grid_search",
                 "train.packing", "utils.trace", "ab_paired", "parallel",
                 "parallel.mesh", "parallel.multihost",
                 "parallel.data_parallel", "parallel.tensor_parallel",
                 "parallel.launch", "trace_steady_state", "bench",
                 "bench_dense_inference", "cli.visualize_obs_density",
                 "cli.visualize_2b_data", "cli.compare_evidence",
                 "cli.synthesize_1b3b", "cli.synthesize_2b"):
        assert f"st_dadk_tpu_torch.{name}" in res["modules"], name
    assert res["forbidden"] == []


def test_sources_name_no_jax_package():
    """No module of the port imports the JAX package or jax by name."""
    for path in (REPO / "st_dadk_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "st_dadk_tpu", "pandas"), \
                    f"{path}: {s}"
            # matplotlib only inside a function (viz/plots.py)
            assert not (line.startswith(("import matplotlib",
                                         "from matplotlib"))), \
                f"{path}: {s}"


def _imported_modules(path):
    import ast
    tree = ast.parse(path.read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    return mods


def test_port_scripts_import_no_jax_package():
    """The scripts that run on the machine with the GPU (the port's accuracy
    run and the comparer) import neither jax, pandas nor the JAX package,
    and the port imports none of the scripts."""
    forbidden = {"jax", "jaxlib", "yaml", "pandas", "st_dadk_tpu"}
    for name in ("port_accuracy_torch.py", "port_accuracy_compare.py",
                 "port_accuracy_competition.py", "port_vml_probe.py"):
        mods = _imported_modules(REPO / "scripts" / name)
        assert not mods & forbidden, (name, mods & forbidden)
    assert "torch" not in _imported_modules(
        REPO / "scripts" / "port_accuracy_compare.py")
    for path in (REPO / "st_dadk_tpu_torch").rglob("*.py"):
        assert "scripts" not in _imported_modules(path), path


def test_port_accuracy_script_refuses_to_run_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable,
                          str(REPO / "scripts" / "port_accuracy_torch.py"),
                          "--output_dir", str(tmp_path / "run")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "no CUDA device" in out.stderr
    assert not (tmp_path / "run").exists()
    assert "jax" not in out.stderr
