"""The competition CLIs of the port (st_dadk_tpu_torch.cli) against the JAX
package's scripts, on the CPU at toy sizes:

  - the flags of each script (the port adds `--device`; score_families'
    defaults name the checkout's `data/` and a `results/` directory);
  - predict_submission and forecast_submission end to end against the JAX
    scripts on one toy family, with JAX's initial params handed to the port
    and JAX's shuffles too (the hash multipliers of the fit, the forecaster's
    permutations), dropout 0: the submissions agree within rtol 1e-4 /
    atol 1e-5, the bar of tests/test_torch_shuffle.py (the same batches,
    float32 sums in another order);
  - score_families: the job list and what each job feeds its fit (exact),
    the scores, and a run of its main;
  - analyze_table_4_4, analyze_grid_search and resume_grid_search against
    the JAX scripts on the same results trees: the CSVs' columns and values
    (the figures only where matplotlib is installed);
  - run_grid_search ends with the analysis.
"""
import csv
import functools
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu.models import forecaster as jfc
from st_dadk_tpu.models import st_interp as jm
from st_dadk_tpu_torch.cli import analyze_grid_search as cli_agrid
from st_dadk_tpu_torch.cli import analyze_table_4_4 as cli_a44
from st_dadk_tpu_torch.cli import forecast_submission as cli_fs
from st_dadk_tpu_torch.cli import predict_submission as cli_ps
from st_dadk_tpu_torch.cli import resume_grid_search as cli_resume
from st_dadk_tpu_torch.cli import run_grid_search as cli_grid
from st_dadk_tpu_torch.cli import score_families as cli_sf
from st_dadk_tpu_torch.models import forecaster as tfc
from st_dadk_tpu_torch.models import st_interp as tm
from st_dadk_tpu_torch.train import loop as tloop

REPO = Path(__file__).resolve().parent.parent
SUB_RTOL, SUB_ATOL = 1e-4, 1e-5
CLIS = {"predict_submission": cli_ps, "forecast_submission": cli_fs,
        "score_families": cli_sf, "analyze_table_4_4": cli_a44,
        "analyze_grid_search": cli_agrid,
        "resume_grid_search": cli_resume}


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
    """(option strings, dest, default, type, choices, nargs, const, action)
    of each argument of the parser a CLI's `main` builds."""
    import argparse
    seen = {}

    def catch(self, *a, **kw):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed):
        main()
    monkeypatch.undo()
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None, a.nargs,
                     a.const, type(a).__name__)
            for a in seen["parser"]._actions}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_flags_equal_the_jax_scripts(name, monkeypatch):
    want = _flags(_jax_script(name).main, monkeypatch)
    got = _flags(CLIS[name].main, monkeypatch)
    if name in ("predict_submission", "forecast_submission",
                "score_families"):
        assert got.pop("device")[0] == ("--device",)
    if name == "score_families":
        # JAX's defaults are paths of its own machine and round
        for dest in ("config", "data_dir", "out"):
            got[dest], want[dest] = got[dest][:1], want[dest][:1]
    assert got == want


# ---------------------------------------------------------------------------
# A toy family in 2a's layout
# ---------------------------------------------------------------------------

T_FULL, T_TRAIN, SITES = 20, 16, 30


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """2a_1 over SITES sites: train t <= T_TRAIN with rows missing at a few
    sites, test t > T_TRAIN at every site without z, the solutions; and a
    tiny config of the port's YAML subset (read by both packages)."""
    from st_dadk_tpu_torch.dataio.competition import write_competition_family
    d = tmp_path_factory.mktemp("family")
    rng = np.random.default_rng(0)
    sites = rng.uniform(size=(SITES, 2)).round(6)
    base = np.sin(4 * sites[:, 0]) + np.cos(3 * sites[:, 1])
    z = np.empty((T_FULL, SITES))
    z[0] = base + rng.normal(0, 0.3, SITES)
    for t in range(1, T_FULL):
        z[t] = base + 0.8 * (z[t - 1] - base) + rng.normal(0, 0.2, SITES)
    rows = [(sites[s, 0], sites[s, 1], t + 1, z[t, s])
            for t in range(T_FULL) for s in range(SITES)]
    np.savetxt(d / "field.csv", np.array(rows), delimiter=",",
               header="x,y,t,z", comments="",
               fmt=["%.6f", "%.6f", "%d", "%.6f"])
    paths = write_competition_family(d / "field.csv", d / "2a", "2a", 1,
                                     T_train=T_TRAIN, site_share=0.2,
                                     row_share=0.3, seed=1)
    (d / "tiny.yaml").write_text(
        "tag: tiny\ndata_file: unused.csv\nepochs: 3\n"
        "k_spatial_centers: [4, 9]\nk_temporal_centers: [5]\n"
        "hidden_dims: [16, 8]\ndropout: 0.0\nbatch_size: 64\n"
        "warmup_epochs: 1\nbasis_unfreeze_epoch: 1\nspatial_learnable: true\n"
        "spatial_init_method: uniform\nregression_type: multi-quantile\n"
        "quantile_levels: [0.1, 0.5, 0.9]\nlr: 5e-3\npatience: 50\n"
        "shuffle: auto\nsave_plots: false\ndevice: cpu\n")
    return d, paths


def _jax_multipliers_by_epoch(seed):
    """The port's `hash_multipliers` handing over the multipliers JAX's fit
    draws each epoch (tests/test_torch_shuffle.py)."""
    root = jax.random.PRNGKey(seed)
    epochs = iter(range(10 ** 6))

    def multipliers(cap, generator, device):
        perm_key, _ = jax.random.split(jax.random.fold_in(root, next(epochs)))
        return torch.as_tensor(np.array(jax.random.randint(
            perm_key, (4,), 0, tloop.hash_width(cap), dtype=jnp.int32)),
            dtype=torch.int64, device=device)
    return multipliers


def _read_z(path):
    return pd.read_csv(path)["z"].to_numpy(np.float64)


def test_predict_submission_matches_jax(family, tmp_path, monkeypatch,
                                        capsys):
    d, paths = family
    seed = 7
    argv = ["--family", str(paths["stem"]), "--config", str(d / "tiny.yaml"),
            "--seed", str(seed)]
    js = _jax_script("predict_submission")
    monkeypatch.setattr(sys, "argv", ["predict_submission.py", *argv,
                                      "--out", str(tmp_path / "jax.csv")])
    js.main()
    out_j = capsys.readouterr().out
    monkeypatch.undo()

    def jax_init(generator, spec, centers, bw, device):
        spec_j = jm.spec_from_config(JaxConfig.from_yaml(d / "tiny.yaml"))
        params, consts = jm.init_model(jax.random.PRNGKey(seed), spec_j,
                                       centers, bw)
        return tm.from_jax_params(spec, params, consts, device=device)

    monkeypatch.setattr(cli_ps, "init_model", jax_init)
    monkeypatch.setattr(tloop, "hash_multipliers",
                        _jax_multipliers_by_epoch(seed))
    summary = cli_ps.main([*argv, "--out", str(tmp_path / "port.csv")])
    out_t = capsys.readouterr().out
    got, want = _read_z(tmp_path / "port.csv"), _read_z(tmp_path / "jax.csv")
    n_test = (T_FULL - T_TRAIN) * SITES
    assert got.shape == want.shape == (n_test,)
    np.testing.assert_array_equal(got, summary["z_hat"])
    np.testing.assert_allclose(got, want, rtol=SUB_RTOL, atol=SUB_ATOL)
    score = [ln for ln in out_t.splitlines() if ln.startswith("[SCORE]")]
    assert len(score) == 1 and "2a-solutions.csv:z1" in score[0]
    sol = pd.read_csv(paths["solutions"])["z1"].to_numpy()
    assert summary["rmse"] == pytest.approx(
        float(np.sqrt(np.mean((got - sol) ** 2))))
    assert [ln.split("RMSE=")[0] for ln in out_t.splitlines()
            if ln.startswith("[SCORE]")] == [
        ln.split("RMSE=")[0] for ln in out_j.splitlines()
        if ln.startswith("[SCORE]")]


def test_forecast_submission_matches_jax(family, tmp_path, monkeypatch,
                                         capsys):
    d, paths = family
    seed = 3
    argv = ["--family", str(paths["stem"]), "--L", "6", "--epochs", "3",
            "--batch_size", "64", "--seed", str(seed)]
    no_dropout = dict(dropout=0.0)
    js = _jax_script("forecast_submission")
    monkeypatch.setattr(js, "ForecastSpec",
                        functools.partial(jfc.ForecastSpec, **no_dropout))
    monkeypatch.setattr(sys, "argv", ["forecast_submission.py", *argv,
                                      "--out", str(tmp_path / "jax.csv")])
    js.main()
    out_j = capsys.readouterr().out
    monkeypatch.undo()

    def jax_init(generator, spec, device):
        params, consts = jfc.init_forecaster(
            jax.random.PRNGKey(seed), jfc.ForecastSpec(**{
                f: getattr(spec, f) for f in spec.__dataclass_fields__}))
        return tfc.forecaster_from_jax(
            spec, jax.tree_util.tree_map(np.asarray, params), consts,
            device=device)

    key = {"k": jax.random.PRNGKey(seed)}

    def jax_randperm(cap, generator=None, device=None):
        key["k"], perm_k, _ = jax.random.split(key["k"], 3)
        return torch.as_tensor(np.array(jax.random.permutation(perm_k, cap)),
                               dtype=torch.int64, device=device)

    monkeypatch.setattr(cli_fs, "ForecastSpec",
                        functools.partial(tfc.ForecastSpec, **no_dropout))
    monkeypatch.setattr(cli_fs, "init_forecaster", jax_init)
    monkeypatch.setattr(torch, "randperm", jax_randperm)
    summary = cli_fs.main([*argv, "--out", str(tmp_path / "port.csv"),
                           "--device", "cpu"])
    monkeypatch.undo()
    out_t = capsys.readouterr().out
    got, want = _read_z(tmp_path / "port.csv"), _read_z(tmp_path / "jax.csv")
    assert got.shape == want.shape == ((T_FULL - T_TRAIN) * SITES,)
    np.testing.assert_allclose(got, want, rtol=SUB_RTOL, atol=SUB_ATOL)
    # sites without a complete history take the fallback, as in JAX
    assert 0 < summary["n_obs_sites"] < SITES
    assert np.isfinite(summary["persistence_rmse"])

    def score(out):
        ln = [x for x in out.splitlines() if x.startswith("[SCORE]")]
        assert len(ln) == 1
        return float(ln[0].split("persistence RMSE=")[1].rstrip(")"))
    assert score(out_t) == pytest.approx(score(out_j), rel=1e-6)
    assert summary["hist"]["val_mse"].shape == (3,)


# ---------------------------------------------------------------------------
# score_families
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """2a (train mode), 1b (solutions only: splitsol), 3a (bivariate train
    mode), 2b (no solutions), and a synth tree for 1b."""
    root = tmp_path_factory.mktemp("families")
    rng = np.random.default_rng(4)
    data, synth = root / "data", root / "synth"

    def xyt(n, t):
        return pd.DataFrame({"x": rng.uniform(size=n).round(5),
                             "y": rng.uniform(size=n).round(5),
                             "t": np.full(n, t)})

    def write(path, df):
        path.parent.mkdir(parents=True, exist_ok=True)
        df.to_csv(path, index=False)

    for i in (1, 2):
        tr = pd.concat([xyt(30, t) for t in (1, 2, 3)], ignore_index=True)
        tr["z"] = np.sin(3 * tr.x) + rng.normal(0, 0.1, len(tr))
        write(data / "2a" / f"2a_{i}_train.csv", tr)
        write(data / "2a" / f"2a_{i}_test.csv", xyt(12, 4))
        tr3 = tr.drop(columns="z").assign(z1=tr.z, z2=-tr.z)
        write(data / "3a" / f"3a_{i}_train.csv", tr3)
        write(data / "3a" / f"3a_{i}_test.csv", xyt(12, 4))
        write(data / "1b" / f"1b_{i}_test.csv", xyt(60, 1))
        write(data / "2b" / f"2b_{i}_test.csv", xyt(5, 1))
    write(data / "2a" / "2a-solutions.csv",
          pd.DataFrame({"id": range(12), "z1": rng.normal(size=12),
                        "z2": rng.normal(size=12)}))
    write(data / "3a" / "3a-solutions.csv",
          pd.DataFrame({"id": range(12), **{f"z{j}": rng.normal(size=12)
                                            for j in (1, 2, 4)}}))
    write(data / "1b" / "1b-solutions.csv",
          pd.DataFrame({"id": range(60), "z1": rng.normal(size=60),
                        "z2": rng.normal(size=60)}))
    write(synth / "1b" / "1b_1.csv",
          pd.concat([xyt(40, 1)], ignore_index=True).assign(
              z=rng.normal(size=40)))
    write(synth / "1b" / "1b_1_synthsol.csv",
          pd.DataFrame({"z": rng.normal(size=60)}))
    return data, synth


def _jobs(mod, data, synth):
    return [{k: str(v) for k, v in j.items()}
            for j in mod.iter_jobs(["1b", "2a", "3a", "2b"], data, synth)]


def test_score_families_jobs_equal_jax(families):
    data, synth = families
    got = _jobs(cli_sf, data, synth)
    want = _jobs(_jax_script("score_families"), data, synth)
    assert got == want
    assert [j["mode"] for j in got].count("synth") == 1
    assert {j["name"] for j in got} >= {"1b_1", "2a_2", "3a_1.z2", "3a_2.z2"}
    assert "3a_2.z1" not in {j["name"] for j in got}   # z3 is not a column


def test_score_families_jobs_feed_their_fits_as_jax(families, monkeypatch):
    """Each job's fit inputs (train coords, normalised t, z, eval points)
    and counts equal JAX's, in all three modes."""
    data, synth = families
    js = _jax_script("score_families")
    cfg_j = JaxConfig(quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95])
    cfg_t = cli_sf.load_config(REPO / "configs" / "config_st_interp.yaml"
                               ).replace(quantile_levels=cfg_j.quantile_levels)
    seen = {"jax": [], "port": []}

    def recorder(side):
        def fit_and_predict(cfg, seed, train_xyt, train_z, eval_xyt,
                            *device):
            seen[side].append((train_xyt, np.asarray(train_z), eval_xyt))
            n = len(eval_xyt[0])
            return np.tile(np.linspace(-1, 1, 5), (n, 1)), 0
        return fit_and_predict

    monkeypatch.setattr(js, "fit_and_predict", recorder("jax"))
    monkeypatch.setattr(cli_sf, "fit_and_predict", recorder("port"))
    for jj, jt in zip(js.iter_jobs(["1b", "2a", "3a"], data, synth),
                      cli_sf.iter_jobs(["1b", "2a", "3a"], data, synth)):
        want = js.run_job(jj, cfg_j, 5, 0.1)
        got = cli_sf.run_job(jt, cfg_t, 5, 0.1, torch.device("cpu"))
        assert got[1:] == want[1:], jt["name"]
        assert got[0] == pytest.approx(want[0], rel=1e-12), jt["name"]
    assert len(seen["jax"]) == len(seen["port"]) == 8
    # pandas' default float parser (xstrtod) may miss the correctly rounded
    # double that numpy's reader gives by one unit in the last place
    for (gx, gz, ge), (wx, wz, we) in zip(seen["port"], seen["jax"]):
        for a, b in ((gx[0], wx[0]), (gx[1], wx[1]), (gz, wz),
                     (ge[0], we[0]), (ge[1], we[1])):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=1e-14, atol=1e-15)


def test_score_equals_jax():
    js = _jax_script("score_families")
    rng = np.random.default_rng(2)
    preds = np.sort(rng.normal(size=(50, 5)), axis=1)
    y = rng.normal(size=50)
    q = [0.05, 0.25, 0.5, 0.75, 0.95]
    got, want = cli_sf.score(preds, y, q), js.score(preds, y, q)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_score_families_main_writes_its_scores(families, tmp_path):
    data, _ = families
    cfg = tmp_path / "c.yaml"
    cfg.write_text("k_spatial_centers: [4]\nk_temporal_centers: [3]\n"
                   "hidden_dims: [8]\nbatch_size: 32\ndevice: cpu\n")
    rows = cli_sf.main(["--families", "2a", "1b", "--data_dir", str(data),
                        "--epochs", "1", "--config", str(cfg), "--only",
                        "2a_1", "1b_2", "--out", str(tmp_path / "out")])
    assert [(r["name"], r["mode"]) for r in rows] == [("2a_1", "train"),
                                                      ("1b_2", "splitsol")]
    for r in rows:
        assert all(np.isfinite(r[m]) for m in ("rmse", "mae", "crps"))
    assert rows[0]["n_eval"] == 12 and rows[1]["n_eval"] == 6
    on_disk = pd.read_csv(tmp_path / "out" / "scores.csv")
    assert list(on_disk["name"]) == ["2a_1", "1b_2"]
    assert json.loads((tmp_path / "out" / "scores.json").read_text()) == rows


# ---------------------------------------------------------------------------
# The analysis scripts on the same results trees
# ---------------------------------------------------------------------------

def _rows(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.reader(f))


def _same_csv(got_path, want_path, rtol=1e-12):
    """Equal header and rows; numeric cells within rtol, others equal."""
    got, want = _rows(got_path), _rows(want_path)
    assert got[0] == want[0], (got[0], want[0])
    assert len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        for a, b, col in zip(g, w, got[0]):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b, (col, a, b)
                continue
            assert (np.isnan(fa) and np.isnan(fb)) or fa == pytest.approx(
                fb, rel=rtol), (col, a, b)


def _table_tree(root, with_summary):
    rng = np.random.default_rng(6)
    cells = [("Fixed_Clustered", "STDK"), ("Fixed_Clustered", "DA-STDK"),
             ("Random_Uniform", "DA-STDK"), ("Fixed_Uniform", "STDK")]
    summaries = {}
    for scen, model in cells:
        crps = rng.uniform(0.4, 0.6, size=3)
        cdir = root / f"table4.4_{scen}_{model}"
        for i, c in enumerate(crps, 1):
            (cdir / "experiments" / str(i)).mkdir(parents=True)
            (cdir / "experiments" / str(i) / "results.json").write_text(
                json.dumps({"test_crps": c}))
        summaries[f"{scen}/{model}"] = {
            "scenario": scen, "model": model, "n": 3,
            "test_crps_mean": float(np.mean(crps)),
            "test_crps_std": float(np.std(crps))}
    if with_summary:
        summaries["_protocol"] = {"quarantined": False}
        (root / "table_4_4_summary.json").write_text(json.dumps(summaries))


@pytest.mark.parametrize("with_summary", [True, False],
                         ids=["summary-json", "walk"])
def test_analyze_table_4_4_equals_jax(tmp_path, monkeypatch, with_summary,
                                      capsys):
    a, b = tmp_path / "port", tmp_path / "jax"
    a.mkdir()
    _table_tree(a, with_summary)
    shutil.copytree(a, b)
    out = cli_a44.main([str(a)])
    assert out == a / "table_4_4_rendered.csv"
    monkeypatch.setattr(sys, "argv", ["analyze_table_4_4.py", str(b)])
    _jax_script("analyze_table_4_4").main()
    _same_csv(a / "table_4_4_rendered.csv", b / "table_4_4_rendered.csv")
    rows = _rows(a / "table_4_4_rendered.csv")
    assert sorted(rows[0]) == ["", "DA-STDK", "STDK"] and len(rows) == 4
    assert "Table 4.4" in capsys.readouterr().out


@pytest.fixture(scope="module")
def grid_tree(tmp_path_factory):
    """A grid of the port's run_grid_search on a toy field: two observation
    ratios x two inits, two seeds; one config's repeat 2 removed."""
    from st_dadk_tpu_torch.sweep.grid import run_grid_search
    tmp = tmp_path_factory.mktemp("grid")
    rng = np.random.default_rng(2)
    coords = rng.uniform(size=(25, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 9):
        for s in range(25):
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},"
                         f"{np.sin(coords[s, 0] * 5) + rng.normal(0, .05):.6f}")
    (tmp / "toy.csv").write_text("\n".join(lines))
    base = dict(data_file=str(tmp / "toy.csv"), k_spatial_centers=[9],
                k_temporal_centers=[4], hidden_dims=[12, 8], dropout=0.0,
                epochs=2, lr=5e-3, batch_size=64, patience=50,
                regression_type="multi-quantile",
                quantile_levels=[0.1, 0.5, 0.9], obs_method="site-wise",
                obs_ratio=0.6, split_method="random", n_experiments=2,
                base_seed=5, save_plots=False, save_artifacts=False,
                device="cpu")
    out = tmp / "results"
    run_grid_search(base, {"obs_ratio": [0.4, 0.6],
                           "spatial_init_method": ["uniform", "gmm"]}, out,
                    engine="sequential", device="cpu")
    shutil.rmtree(next(out.glob("config004*")) / "experiments" / "2")
    return out


def test_analyze_grid_search_equals_jax(grid_tree, tmp_path, monkeypatch,
                                        capsys):
    a, b = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(grid_tree, a)
    shutil.copytree(grid_tree, b)
    detailed = cli_agrid.main([str(a)])
    out_t = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["analyze_grid_search.py", str(b)])
    _jax_script("analyze_grid_search").main()
    out_j = capsys.readouterr().out
    for f in ("grid_search_summary.csv", "grid_search_detail.csv",
              "grid_search_configs.csv", "detailed_summary.csv"):
        _same_csv(a / f, b / f)
    assert len(detailed) == 4
    best = lambda out: sorted(ln.split(":")[1].split("(")[0].strip()
                              for ln in out.splitlines() if "best " in ln)
    assert best(out_t) == best(out_j) and len(best(out_t)) == 2
    if importlib.util.find_spec("matplotlib") is not None:
        assert (a / "boxplot_test_rmse.png").exists()
        assert (a / "boxplot_test_crps_by_obs_ratio.png").exists()


def test_analyze_grid_search_without_matplotlib_writes_the_csvs(
        grid_tree, tmp_path, monkeypatch, capsys):
    a = tmp_path / "port"
    shutil.copytree(grid_tree, a)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cli_agrid.main([str(a)])
    assert "[WARNING] no figures" in capsys.readouterr().out
    assert (a / "detailed_summary.csv").exists()
    assert not list(a.glob("*.png"))


def test_resume_grid_search_equals_jax(grid_tree, tmp_path, monkeypatch):
    a, b = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(grid_tree, a)
    shutil.copytree(grid_tree, b)
    got = cli_resume.main([str(a), "--summarize-only"])
    monkeypatch.setattr(sys, "argv", ["resume_grid_search.py", str(b),
                                      "--summarize-only"])
    _jax_script("resume_grid_search").main()
    assert len(got) == 4
    for f in ("grid_search_summary.csv", "grid_search_detail.csv",
              "grid_search_configs.csv"):
        _same_csv(a / f, b / f)
    # a resume with --skip-existing fills the missing repeat only
    cdir = next(a.glob("config004*"))
    before = (cdir / "experiments" / "1" / "results.json").read_text()
    cli_resume.main([str(a), "--skip-existing", "--engine", "sequential"])
    assert (cdir / "experiments" / "2" / "results.json").exists()
    assert (cdir / "experiments" / "1" / "results.json").read_text() == before
    st = json.loads((cdir / "summary" / "summary_statistics.json")
                    .read_text())
    assert st["n_experiments"] == 2


def test_run_grid_search_ends_with_the_analysis(tmp_path, capsys):
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(20, 2)).round(5)
    lines = ["x,y,t,z"] + [f"{coords[s, 0]},{coords[s, 1]},{t},"
                           f"{np.sin(4 * coords[s, 0]):.6f}"
                           for t in range(1, 7) for s in range(20)]
    (tmp_path / "toy.csv").write_text("\n".join(lines))
    (tmp_path / "c.yaml").write_text(
        f"data_file: {tmp_path / 'toy.csv'}\nepochs: 1\nn_experiments: 1\n"
        "k_spatial_centers: [4]\nk_temporal_centers: [3]\n"
        "hidden_dims: [8]\nbatch_size: 64\nobs_ratio: 0.5\n"
        "regression_type: multi-quantile\nquantile_levels: [0.1, 0.5, 0.9]\n"
        "save_plots: false\ndevice: cpu\n")
    out = tmp_path / "grid"
    grid = {"spatial_init_method": ["uniform"], "spatial_learnable": [False],
            "obs_ratio": [0.4, 0.6]}
    cli_grid.main(["--config", str(tmp_path / "c.yaml"), "--param_grid",
                   json.dumps(grid), "--output_dir", str(out)])
    assert (out / "detailed_summary.csv").exists()
    assert "best test_rmse" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# compare_evidence on the port's trees: the JAX package's script (which
# imports neither package) and the port's copy print the same tables
# ---------------------------------------------------------------------------

def _compare_both(mode, old, new):
    import subprocess

    from st_dadk_tpu_torch.cli import compare_evidence as ce

    theirs = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "compare_evidence.py"),
         mode, str(old), str(new)], capture_output=True, text=True,
        timeout=120)
    assert theirs.returncode == 0, theirs.stderr
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ce.main([mode, str(old), str(new)]) == 0
    assert buf.getvalue() == theirs.stdout
    return theirs.stdout


def test_compare_evidence_reads_the_port_grid_tree(grid_tree):
    got = _compare_both("grid", grid_tree, grid_tree)
    assert got.count("| +0.0000 |") == 4
    assert "max |delta| = 0.00 sigma_mean across configs" in got


def test_compare_evidence_reads_the_port_family_scores(families, tmp_path):
    data, _ = families
    cfg = tmp_path / "c.yaml"
    cfg.write_text("k_spatial_centers: [4]\nk_temporal_centers: [3]\n"
                   "hidden_dims: [8]\nbatch_size: 32\ndevice: cpu\n")
    rows = cli_sf.main(["--families", "2a", "--data_dir", str(data),
                        "--epochs", "1", "--config", str(cfg), "--only",
                        "2a_1", "--out", str(tmp_path / "out")])
    got = _compare_both("families", tmp_path / "out", tmp_path / "out")
    r = rows[0]
    assert f"| {r['name']} | " + " | ".join(
        f"{r[c]:.3f} -> {r[c]:.3f}" for c in ("rmse", "mae", "crps")) + " |" \
        in got
