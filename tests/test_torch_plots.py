"""The figures and the NaN diagnostics of the port's finalize
(st_dadk_tpu_torch.train.experiment, st_dadk_tpu_torch.viz.plots) against
the JAX package's: the same toy fit writes the same figure files, per
experiment, per tau and in the run's summary; a figure that raises (or a
missing matplotlib, as on the machine with the GPU) leaves the results
whole; forced NaN epochs write `nan_diagnostics.json` keyed as JAX keys
it."""
import json
import sys

import numpy as np
import pytest

from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu.train import experiment as jexp
from st_dadk_tpu.train import runner as jrunner
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.train import experiment as texp
from st_dadk_tpu_torch.train import runner as trunner
from st_dadk_tpu_torch.viz import plots
from torch_threads import worker_threads  # noqa: F401

TOY = dict(k_spatial_centers=[4], k_temporal_centers=[3], hidden_dims=[8],
           epochs=2, batch_size=32, obs_ratio=0.5, spatial_learnable=True,
           spatial_init_method="gmm", regression_type="multi-quantile",
           quantile_levels=[0.1, 0.5, 0.9], use_pallas=False)


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    d = tmp_path_factory.mktemp("plots")
    rng = np.random.default_rng(5)
    coords = rng.uniform(size=(20, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 7):
        for s in range(20):
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},"
                         f"{np.sin(3 * coords[s, 0]) + 0.1 * t:.6f}")
    (d / "toy.csv").write_text("\n".join(lines))
    return d / "toy.csv"


def _pngs(d):
    return sorted(p.name for p in d.glob("*.png"))


def _run_both(toy_csv, tmp_path, **kw):
    d = dict(TOY, data_file=str(toy_csv), **kw)
    rj = jexp.run_single_experiment(JaxConfig.from_dict(d), 1, tmp_path / "j",
                                    verbose=False)
    rt = texp.run_single_experiment(
        ExperimentConfig.from_dict(dict(d, device="cpu")), 1, tmp_path / "t",
        verbose=False)
    return rj, rt


def test_same_figures_as_jax(toy_csv, tmp_path):
    _run_both(toy_csv, tmp_path)
    want = _pngs(tmp_path / "j")
    assert len(want) == 7           # six families, two series figures
    assert _pngs(tmp_path / "t") == want
    # the run's two summary figures from the experiments' predictions.npz
    res = [json.loads((tmp_path / "t" / "results.json").read_text())]
    trunner.aggregate_results(res, tmp_path / "ts")
    jrunner.aggregate_results(res, tmp_path / "js")
    assert _pngs(tmp_path / "ts") == _pngs(tmp_path / "js") == [
        "averaged_spatial_mse.png", "observation_density.png"]


def test_per_tau_combined_fan_chart_as_jax(toy_csv, tmp_path):
    _run_both(toy_csv, tmp_path, regression_type="quantile", epochs=1)
    assert _pngs(tmp_path / "t") == _pngs(tmp_path / "j") == [
        "combined_quantile_series.png"]
    for q in (0.1, 0.5, 0.9):
        assert _pngs(tmp_path / "t" / f"quantile_{q}") == \
            _pngs(tmp_path / "j" / f"quantile_{q}")


def _no_figures(toy_csv, tmp_path):
    cfg = ExperimentConfig.from_dict(dict(TOY, data_file=str(toy_csv),
                                          device="cpu", save_plots=False))
    return texp.run_single_experiment(cfg, 1, tmp_path / "off",
                                      verbose=False)


def _same_results(a, b):
    skip = {"total_time_seconds", "total_time_formatted", "timestamp",
            "stage_timings", "steps_per_second", "config"}
    assert {k: v for k, v in a.items() if k not in skip} == \
        {k: v for k, v in b.items() if k not in skip}


def test_a_failing_figure_leaves_the_results_whole(toy_csv, tmp_path,
                                                   monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("no figure today")

    monkeypatch.setattr(plots, "plot_predictions", boom)
    cfg = ExperimentConfig.from_dict(dict(TOY, data_file=str(toy_csv),
                                          device="cpu"))
    res = texp.run_single_experiment(cfg, 1, tmp_path / "t", verbose=False)
    assert "[WARNING] plotting failed: no figure today" in \
        capsys.readouterr().out
    # the families before the failing one are written, none after it
    assert _pngs(tmp_path / "t") == ["observation_pattern.png",
                                     "training_curves.png"]
    written = json.loads((tmp_path / "t" / "results.json").read_text())
    _same_results(written, json.loads(json.dumps(_no_figures(toy_csv,
                                                             tmp_path))))
    assert res["test_crps"] == written["test_crps"]


def test_without_matplotlib_the_fit_completes(toy_csv, tmp_path,
                                              monkeypatch, capsys):
    """The GPU machine has no matplotlib: through the lane engine, every
    figure family's import fails inside its try, the fit and the run
    summary complete with the warning, and no PNG is written."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = ExperimentConfig.from_dict(dict(TOY, data_file=str(toy_csv),
                                          device="cpu", n_experiments=1))
    trunner.run_multiple_experiments(cfg, tmp_path, engine="vmap",
                                     device="cpu", verbose=False)
    out = capsys.readouterr().out
    assert "[WARNING] plotting failed" in out
    assert "[WARNING] summary figures failed" in out
    assert not list(tmp_path.rglob("*.png"))
    assert (tmp_path / "experiments" / "1" / "results.json").exists()
    assert (tmp_path / "summary" / "summary_statistics.json").exists()


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_nan_epochs_write_jax_keyed_diagnostics(toy_csv, tmp_path):
    """An LR that overflows the weights in the first step poisons every
    epoch; both packages write nan_diagnostics.json, keyed alike."""
    _run_both(toy_csv, tmp_path, lr=1e38, save_plots=False)
    want = json.loads((tmp_path / "j" / "nan_diagnostics.json").read_text())
    got = json.loads((tmp_path / "t" / "nan_diagnostics.json").read_text())
    assert _keys(got) == _keys(want)
    assert got["nan_epochs"] == want["nan_epochs"] == [0, 1]
    assert got["inputs"] == want["inputs"]
    for name, stats in want["params"].items():
        assert got["params"][name]["shape"] == stats["shape"], name
    # no epoch improved, so the serving params are the last EMA's
    assert got["params"]["final_ema.mlp.linear_0.w"]["n_nonfinite"] > 0
