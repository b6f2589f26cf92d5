"""The port's three command lines (st_dadk_tpu_torch.cli) against the JAX
package's scripts: the same flags, the same Table 4.4 configs, and a short
CPU run of each on a toy field with its output tree."""
import argparse
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu_torch.cli import run_grid_search as cli_grid
from st_dadk_tpu_torch.cli import run_table_4_4 as cli_t44
from st_dadk_tpu_torch.cli import train_st_interp as cli_train
from st_dadk_tpu_torch.config import ExperimentConfig

REPO = Path(__file__).resolve().parent.parent
CLIS = {"train_st_interp": cli_train, "run_grid_search": cli_grid,
        "run_table_4_4": cli_t44}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The toy fits run thousands of small ops; on a shared CPU, intra-op
    threads only add overhead to them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _flags(main, monkeypatch):
    """The parser a CLI's `main` builds, caught at its parse_args: one
    (option strings, dest, default, type, choices, nargs, const, action)
    an argument, help left out."""
    seen = {}

    def catch(self, *a, **kw):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed):
        main()
    return sorted((tuple(a.option_strings), a.dest, a.default, a.type,
                   tuple(a.choices) if a.choices else None, a.nargs, a.const,
                   type(a).__name__) for a in seen["parser"]._actions)


@pytest.mark.parametrize("name", sorted(CLIS))
def test_flags_equal_the_jax_scripts(name, monkeypatch):
    want = _flags(_jax_script(name).main, monkeypatch)
    got = _flags(CLIS[name].main, monkeypatch)
    assert got == want


@pytest.mark.parametrize("kw", [
    {}, {"da_stdk_init_method": "gmm", "non_crossing_lambda": 0.5,
         "data_file": "data/x.csv", "delta_penalty_mode": "eq310"}],
    ids=["protocol", "flags"])
def test_table_4_4_configs_equal_jax(kw):
    js = _jax_script("run_table_4_4")
    assert cli_t44.SCENARIOS == js.SCENARIOS and cli_t44.MODELS == js.MODELS
    path = REPO / "configs" / "config_st_interp.yaml"
    args = [kw.get(k) for k in ("da_stdk_init_method", "non_crossing_lambda",
                                "data_file")]
    mode = kw.get("delta_penalty_mode", "abs")
    got = cli_t44.create_table_4_4_configs(path, *args, mode)
    want = js.create_table_4_4_configs(path, *args, mode)
    assert [(s, m) for s, m, _ in got] == [(s, m) for s, m, _ in want]
    jax_only = ({f for f in JaxConfig.__dataclass_fields__}
                - set(ExperimentConfig.__dataclass_fields__))
    port_only = ({f for f in ExperimentConfig.__dataclass_fields__}
                 - set(JaxConfig.__dataclass_fields__))
    for (_, _, g), (_, _, w) in zip(got, want):
        common = set(g) & set(w)
        assert {k: g[k] for k in common} == {k: w[k] for k in common}
        # the rest are fields of one package only, at their defaults
        assert set(w) - common <= jax_only
        assert set(g) - common <= port_only
        for k in ("regression_type", "quantile_levels", "obs_ratio",
                  "use_delta_reparameterization", "non_crossing_lambda",
                  "non_crossing_delta_mode", "data_file", "obs_method",
                  "obs_spatial_pattern", "spatial_init_method",
                  "spatial_learnable", "tag", "device"):
            assert k in common, k


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A toy field and a config file of the port's YAML subset that names
    the CPU."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(4 * coords[s, 0]) + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (d / "toy.csv").write_text("\n".join(lines))
    (d / "tiny.yaml").write_text(
        f"# a tiny fit on the CPU\ntag: tiny\ndata_file: {d / 'toy.csv'}\n"
        "epochs: 2\nn_experiments: 2\nk_spatial_centers: [4, 9]\n"
        "k_temporal_centers: [5]\nhidden_dims: [16, 8]\nbatch_size: 64\n"
        "obs_ratio: 0.5\nwarmup_epochs: 1\nbasis_unfreeze_epoch: 1\n"
        "spatial_init_method: uniform\nregression_type: multi-quantile\n"
        "quantile_levels: [0.1, 0.5, 0.9]\nlr: 5e-3\nsave_artifacts: true\n"
        "save_plots: false\ndevice: cpu\n")
    return d


def _check_run_tree(root, n):
    assert (root / "config.yaml").exists()
    for i in range(1, n + 1):
        r = json.loads((root / "experiments" / str(i) / "results.json")
                       .read_text())
        assert np.isfinite(r["test_crps"])
    st = json.loads((root / "summary" / "summary_statistics.json").read_text())
    assert st["n_experiments"] == n
    assert (root / "summary" / "all_experiments.csv").exists()


def test_train_st_interp_runs_and_writes_its_tree(toy, tmp_path, monkeypatch):
    out = tmp_path / "vmap"
    summary = cli_train.main(["--config", str(toy / "tiny.yaml"),
                              "--parallel", "--output_dir", str(out)])
    assert summary["n_experiments"] == 2
    _check_run_tree(out, 2)
    cfg = ExperimentConfig.from_yaml(out / "config.yaml")
    assert cfg.tag == "tiny" and cfg.device == "cpu" and cfg.lr == 5e-3
    # no --output_dir: results/<date>/<time>_<tag>/, sequential fits, and the
    # flags override the config
    monkeypatch.chdir(tmp_path)
    cli_train.main(["--config", str(toy / "tiny.yaml"), "--n_experiments",
                    "1", "--base_seed", "7"])
    (day,) = (tmp_path / "results").iterdir()
    (run,) = day.iterdir()
    assert len(day.name) == 8 and run.name.endswith("_tiny")
    _check_run_tree(run, 1)
    r = json.loads((run / "experiments" / "1" / "results.json").read_text())
    assert r["experiment_seed"] == 7
    # --engine dp runs (one process: each fit data-parallel over one rank)
    summary = cli_train.main(["--config", str(toy / "tiny.yaml"), "--engine",
                              "dp", "--n_experiments", "1", "--output_dir",
                              str(tmp_path / "dp")])
    assert summary["n_experiments"] == 1
    _check_run_tree(tmp_path / "dp", 1)


def test_run_grid_search_runs_and_dry_runs(toy, tmp_path, capsys):
    grid = json.dumps({"spatial_init_method": ["uniform", "random_site"],
                       "spatial_learnable": [True, False]})
    out = tmp_path / "grid"
    assert cli_grid.main(["--config", str(toy / "tiny.yaml"), "--param_grid",
                          grid, "--output_dir", str(out), "--dry-run"]) is None
    assert "2 configs (dry run; nothing executed)" in capsys.readouterr().out
    assert not out.exists()
    res = cli_grid.main(["--config", str(toy / "tiny.yaml"), "--param_grid",
                         grid, "--output_dir", str(out), "--n_experiments",
                         "1"])
    assert [r["config"]["tag"] for r in res] == [
        "config001_uni_fix", "config002_rnd_lrn"]
    assert all(r["status"] == "success" for r in res)
    for f in ("grid_search_summary.csv", "grid_search_detail.csv",
              "grid_search_configs.json", "grid_search_configs.csv"):
        assert (out / f).exists(), f
    for r in res:
        _check_run_tree(out / r["config"]["tag"], 1)
    assert f"Results: {out}" in capsys.readouterr().out


@pytest.fixture(scope="module")
def t44_run(toy, tmp_path_factory):
    """(summary, output dir) of a Table 4.4 run through the CLI."""
    out = tmp_path_factory.mktemp("t44") / "t44"
    summary = cli_t44.main([
        "--config", str(toy / "tiny.yaml"), "--data_file",
        str(toy / "toy.csv"), "--n_experiments", "1", "--engine", "vmap",
        "--overrides", json.dumps({"epochs": 2, "basis_unfreeze_epoch": 1}),
        "--output_dir", str(out)])
    return summary, out


def test_run_table_4_4_runs_its_eight_cells(t44_run):
    summary, out = t44_run
    on_disk = json.loads((out / "table_4_4_summary.json").read_text())
    assert summary == dict(on_disk, _output_dir=str(out))
    cells = {k: v for k, v in on_disk.items() if not k.startswith("_")}
    assert len(cells) == 8
    assert all(e["n"] == 1 and np.isfinite(e["test_crps_mean"])
               for e in cells.values())
    assert on_disk["_protocol"] == {
        "delta_penalty_mode": "abs", "quarantined": False,
        "overrides": {"epochs": 2, "basis_unfreeze_epoch": 1}}
    for key, e in cells.items():
        cdir = out / f"table4.4_{e['scenario']}_{e['model']}"
        assert json.loads((cdir / "scenario_summary.json").read_text()) == e
        cfg = ExperimentConfig.from_yaml(cdir / "config.yaml")
        assert cfg.spatial_init_method == (
            "kmeans_balanced" if e["model"] == "DA-STDK" else "uniform")
        assert cfg.epochs == 2 and cfg.use_delta_reparameterization
        _check_run_tree(cdir, 1)
    assert not (out / "QUARANTINE_eq310.txt").exists()


def test_compare_evidence_reads_the_port_table(t44_run, tmp_path, capsys):
    """The port's compare_evidence renders a Table 4.4 tree of the port as
    it is, '_protocol' and all; on a copy without the run's notes it prints
    what the JAX package's script prints."""
    import subprocess
    import sys

    from st_dadk_tpu_torch.cli import compare_evidence as ce

    _, out = t44_run
    assert ce.main(["table", str(out), str(out)]) == 0
    got = capsys.readouterr().out
    assert got.count("| +0.0000 |") == 8
    assert "max |delta| = 0.00 sigma_mean across cells" in got
    bare = tmp_path / "bare"
    bare.mkdir()
    cells = json.loads((out / "table_4_4_summary.json").read_text())
    (bare / "table_4_4_summary.json").write_text(json.dumps(
        {k: v for k, v in cells.items() if not k.startswith("_")}))
    assert ce.main(["table", str(bare), str(out)]) == 0
    mine = capsys.readouterr().out
    theirs = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "compare_evidence.py"),
         "table", str(bare), str(bare)], capture_output=True, text=True,
        timeout=120)
    assert theirs.returncode == 0, theirs.stderr
    assert mine.replace(out.name, bare.name) == theirs.stdout


def test_run_table_4_4_quarantines_eq310(toy, tmp_path, monkeypatch):
    ran = []
    monkeypatch.setattr(cli_t44, "run_multiple_experiments",
                        lambda cfg, d, **kw: ran.append(cfg.tag))
    out = tmp_path / "q"
    summary = cli_t44.main(["--config", str(toy / "tiny.yaml"),
                            "--delta_penalty_mode", "eq310",
                            "--output_dir", str(out)])
    assert (out / "QUARANTINE_eq310.txt").read_text() == \
        cli_t44.EQ310_WARNING + "\n"
    assert summary["_protocol"]["quarantined"] and len(ran) == 8
    assert all(summary[k]["n"] == 0 for k in summary if not k.startswith("_"))
