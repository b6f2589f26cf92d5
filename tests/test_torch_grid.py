"""The port's grid-search engine (st_dadk_tpu_torch.sweep.grid) against the
JAX package's (st_dadk_tpu.sweep.grid): configs and tags, the buckets and
ragged pads of the lane engine, and the grid-level CSV files cell for
cell; and a small grid run end to end on the CPU."""
import csv
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from st_dadk_tpu.sweep import grid as jg
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.sweep import grid as tg

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The toy fits and the Sinkhorn loop run thousands of small ops; on a
    shared CPU, intra-op threads only add overhead to them."""
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


def _write_toy(path, seed=0, sites=40, times=12):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(sites, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, times + 1):
        for s in range(sites):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    path.write_text("\n".join(lines))


def test_configs_and_tags_of_the_cli_grid_equal_jax():
    from st_dadk_tpu_torch.cli import run_grid_search as cli
    js = _jax_script("run_grid_search")
    assert cli.PARAM_GRID == js.PARAM_GRID
    base = ExperimentConfig.from_yaml(
        REPO / "configs" / "config_st_interp.yaml").to_dict()
    got = tg.generate_config_combinations(base, cli.PARAM_GRID,
                                          cli.config_filter)
    want = jg.generate_config_combinations(base, js.PARAM_GRID,
                                           js.config_filter)
    assert got == want and len(got) == 12
    assert got[0]["tag"] == "config001_2a_7_wend_uni_fix_rand_10_cor"


def test_tags_with_truncated_ratios_and_paths_equal_jax():
    grid = {"data_file": ["data/2a/2a_8.csv", "/abs/dir/2b_9.csv"],
            "obs_ratio": [0.29, 0.1, 0.57],
            "spatial_init_method": ["gmm", "random_site", "kmeans_exact",
                                    "other"],
            "spatial_basis_function": ["gaussian"],
            "obs_spatial_pattern": ["corner", "uniform"],
            "obs_method": ["site-wise", "random"],
            "k_spatial_centers": [[25, 81], [25, 81, 121]]}
    keep = lambda p: not (p["obs_method"] == "random"
                          and p["spatial_init_method"] == "other")
    got = tg.generate_config_combinations({"tag": "base", "lr": 0.01}, grid,
                                          keep)
    want = jg.generate_config_combinations({"tag": "base", "lr": 0.01}, grid,
                                           keep)
    assert got == want
    tags = [c["tag"] for c in got]
    assert "config001_2a_8_28_gmm_gaus_cor_site_[25, 81]" in tags
    assert [c["config_id"] for c in got] == list(range(1, len(got) + 1))


def _captured_jobs(monkeypatch, module, run, configs, out):
    """The jobs each bucket hands to `run_lane_jobs`, without fitting:
    (tag, experiment id, k_spatial_pad, resolutions, tau) a lane."""
    buckets = []

    def capture(jobs, cfg, **kw):
        buckets.append([(Path(d).relative_to(out).parts[0], i,
                         c.k_spatial_pad, list(c.k_spatial_centers),
                         c.current_quantile) for c, i, d in jobs])
        return []

    monkeypatch.setattr(module, "run_lane_jobs", capture)
    # and no per-tau aggregation, which would fit what was not run
    monkeypatch.setattr(module, "aggregate_per_tau", lambda *a, **kw: [])
    run(configs, out)
    return buckets


def test_buckets_and_ragged_pads_equal_jax(tmp_path, monkeypatch):
    from st_dadk_tpu.train import batch_engine as jbe
    from st_dadk_tpu_torch.train import batch_engine as tbe

    _write_toy(tmp_path / "a.csv")
    _write_toy(tmp_path / "b.csv", seed=1, sites=30)
    base = dict(tag="g", k_temporal_centers=[4], hidden_dims=[8],
                n_experiments=2, regression_type="multi-quantile",
                quantile_levels=[0.1, 0.5, 0.9], epochs=1, save_plots=False)
    grid = {"data_file": [str(tmp_path / "a.csv"), str(tmp_path / "b.csv")],
            "k_spatial_centers": [[4], [4, 9], [9, 16]],
            "spatial_init_method": ["uniform", "kmeans_balanced"],
            "regression_type": ["multi-quantile", "quantile"]}
    configs = tg.generate_config_combinations(base, grid)
    # a config with its own pad keeps it, and keeps its group unpadded
    configs[0] = dict(configs[0], k_spatial_pad=30)
    want = _captured_jobs(
        monkeypatch, jbe, lambda c, o: jg._run_grid_stacked(
            c, o, skip_existing=False, verbose=False), configs, tmp_path)
    got = _captured_jobs(
        monkeypatch, tbe, lambda c, o: tg._run_grid_stacked(
            c, o, skip_existing=False, verbose=False), configs, tmp_path)
    assert got == want
    pads = {p for b in got for _, _, p, _, _ in b}
    assert pads == {30, None, 25}
    # per-tau configs run a lane a (experiment, tau)
    assert any(t == 0.5 for b in got for *_, t in b)


def _summary(values):
    stats = {}
    for m, vals in values.items():
        arr = np.asarray(vals, np.float64)
        stats[m] = {"mean": float(arr.mean()), "std": float(arr.std()),
                    "min": float(arr.min()), "max": float(arr.max()),
                    "median": float(np.median(arr)),
                    "values": [float(v) for v in arr]}
    return {"n_experiments": len(next(iter(values.values()))),
            "statistics": stats}


def test_grid_csv_files_equal_jax_cell_for_cell(tmp_path):
    cfgs = tg.generate_config_combinations(
        {"tag": "b", "n_experiments": 3},
        {"spatial_init_method": ["uniform", "kmeans_balanced", "gmm"],
         "spatial_learnable": [True, False], "obs_ratio": [0.1, 0.29]})
    all_results = [None]
    for i, c in enumerate(cfgs):
        if i == 2:
            all_results.append({"config": c, "summary": None,
                                "status": "failed", "error": "x"})
            continue
        vals = {"test_rmse": [0.5 + i, 0.25, 1e-5],
                "total_time_seconds": [1.0, 2.0, 3.0]}
        if i % 3 == 0:         # a quantile config: CRPS and check losses
            vals.update(test_crps=[0.1, 0.2, float(i)],
                        test_check_loss=[1.5e20, 2.0, 3.0])
        if i == 3:             # a NaN metric: an empty cell
            vals["total_time_seconds"][1] = float("nan")
        if i == 4:             # a repeat missing: fewer values
            vals = {k: v[:2] for k, v in vals.items()}
        all_results.append({"config": c, "summary": _summary(vals),
                            "status": "success"})
    jg.save_experiment_results(all_results, tmp_path / "jax")
    tg.save_experiment_results(all_results, tmp_path / "port")
    for f in ("grid_search_summary.csv", "grid_search_detail.csv",
              "grid_search_configs.csv", "grid_search_configs.json"):
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "jax" / f).read_text(), f


def test_a_small_grid_end_to_end(tmp_path):
    """uniform+fixed and kmeans_balanced+learnable over two resolution
    lists, 2 seeds, vmap: two ragged buckets, one summary a config, the
    four grid files, and the sequential engine's configs alike."""
    from st_dadk_tpu_torch.cli.run_grid_search import config_filter
    _write_toy(tmp_path / "toy.csv")
    base = dict(tag="g", data_file=str(tmp_path / "toy.csv"), device="cpu",
                k_temporal_centers=[4], hidden_dims=[16, 8], epochs=2,
                n_experiments=2, batch_size=64, obs_ratio=0.5,
                obs_method="site-wise", regression_type="multi-quantile",
                quantile_levels=[0.1, 0.5, 0.9], warmup_epochs=1,
                basis_unfreeze_epoch=1, save_artifacts=True,
                save_plots=False)
    grid = {"spatial_init_method": ["uniform", "kmeans_balanced"],
            "spatial_learnable": [True, False],
            "k_spatial_centers": [[4], [4, 9]]}
    res = tg.run_grid_search(base, grid, tmp_path / "vmap",
                             filter_fn=config_filter, engine="vmap")
    assert [r["status"] for r in res] == ["success"] * 4
    for r in res:
        d = tmp_path / "vmap" / r["config"]["tag"]
        assert ExperimentConfig.from_yaml(d / "config.yaml").to_dict() == \
            ExperimentConfig.from_dict(r["config"]).to_dict()
        st = json.loads((d / "summary" / "summary_statistics.json")
                        .read_text())
        assert st["n_experiments"] == 2
        lane = json.loads((d / "experiments" / "1" / "results.json")
                          .read_text())
        # stripped back to the config's own resolutions after the padding
        info = np.load(d / "experiments" / "1" / "basis_info.npz")
        assert info["spatial_centers_final"].shape[0] == sum(
            r["config"]["k_spatial_centers"])
        assert np.isfinite(lane["test_crps"])
    with open(tmp_path / "vmap" / "grid_search_summary.csv",
              newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["tag"] for r in rows] == [r["config"]["tag"] for r in res]
    seq = tg.run_grid_search(dict(base, n_experiments=1), grid,
                             tmp_path / "seq", filter_fn=config_filter,
                             engine="sequential")
    assert [r["config"]["tag"] for r in seq] == \
        [r["config"]["tag"] for r in res]
    assert all(r["status"] == "success" for r in seq)


def test_a_failing_bucket_is_reported_not_raised(tmp_path):
    base = dict(tag="g", data_file=str(tmp_path / "absent.csv"),
                device="cpu", n_experiments=1, epochs=1)
    res = tg.run_grid_search(base, {"obs_ratio": [0.1]}, tmp_path,
                             engine="vmap")
    assert [r["status"] for r in res] == ["failed"]
    assert (tmp_path / "grid_search_configs.json").exists()
