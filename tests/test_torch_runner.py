"""The port's runner (st_dadk_tpu_torch.train.runner): aggregation against
the JAX package's on the same results, and `run_multiple_experiments` with
the sequential engine on a toy field (CPU). The vmap engine is driven in
tests/test_torch_batch_engine.py."""
import csv
import json

import numpy as np
import pytest

from st_dadk_tpu.train import runner as jrunner
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.train import experiment as texp
from st_dadk_tpu_torch.train import runner as trunner
from torch_threads import worker_threads  # noqa: F401


def _cfg(toy_dir, **kw):
    """The config of tests/test_batch_engine.py::_cfg, on the CPU."""
    base = dict(
        tag="runnertest", data_file=str(toy_dir / "toy.csv"),
        k_spatial_centers=[9], k_temporal_centers=[4], hidden_dims=[16, 8],
        dropout=0.0, epochs=4, lr=5e-3, batch_size=64, patience=50,
        warmup_epochs=1, scheduler="cosine", grad_clip=10.0,
        regression_type="mean", obs_method="site-wise", obs_ratio=0.5,
        obs_spatial_pattern="uniform", split_method="random", train_ratio=0.8,
        n_experiments=3, base_seed=100, save_artifacts=True, device="cpu",
        save_plots=False)
    base.update(kw)
    return ExperimentConfig.from_dict(base)


@pytest.fixture
def toy_csv(tmp_path):
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (tmp_path / "toy.csv").write_text("\n".join(lines))
    return tmp_path


# ---------------------------------------------------------------------------
# aggregate_results against the JAX package's
# ---------------------------------------------------------------------------

def _results(kind):
    """Synthetic results.json contents, from a numpy seed."""
    rng = np.random.default_rng(4)
    out = []
    for i in range(1, 6):
        r = {"experiment_id": i, "experiment_seed": 2024 + i,
             "total_time_seconds": float(rng.uniform(1, 9))}
        for split in ("train", "valid", "test"):
            for m in ("mse", "mae", "rmse"):
                r[f"{split}_{m}"] = float(rng.uniform(0.1, 2.0))
        if kind in ("quantile", "partial_quantile"):
            for m in trunner.QUANTILE_METRICS:
                r[m] = float(rng.uniform(0.1, 1.0))
        out.append(r)
    if kind == "partial_quantile":
        del out[2]["test_crps"]          # then the column is left out
    if kind == "missing_metric":
        del out[1]["valid_mae"]          # zero-filled, as the reference does
        del out[3]["total_time_seconds"]
    if kind == "nested":
        for r in out:
            r["metrics"] = {s: {m: r.pop(f"{s}_{m}")
                                for m in ("mse", "mae", "rmse")}
                            for s in ("train", "valid", "test")}
            del r["experiment_seed"]
    return out


@pytest.mark.parametrize("kind", ["flat", "quantile", "partial_quantile",
                                  "missing_metric", "nested"])
def test_aggregate_results_equals_jax(kind, tmp_path):
    """`summary_statistics.json` equal and `all_experiments.csv` equal cell
    by cell: the same float64 numpy reductions on the same lists, so the
    bar is exact equality."""
    want = jrunner.aggregate_results(_results(kind), tmp_path / "j")
    got = trunner.aggregate_results(_results(kind), tmp_path / "t")
    assert got == want
    assert (json.loads((tmp_path / "t" / "summary_statistics.json").read_text())
            == json.loads((tmp_path / "j" / "summary_statistics.json").read_text()))
    rows = []
    for side in ("j", "t"):
        with open(tmp_path / side / "all_experiments.csv", newline="") as f:
            rows.append(list(csv.reader(f)))
    assert rows[0] == rows[1]
    assert len(rows[1]) == 6
    if kind == "quantile":
        assert rows[1][0] == (["experiment_id", "experiment_seed"]
                              + trunner.AGG_METRICS
                              + trunner.QUANTILE_METRICS)
    if kind == "missing_metric":
        assert got["statistics"]["valid_mae"]["min"] == 0.0


def test_metric_lists_equal_jax():
    assert trunner.AGG_METRICS == jrunner.AGG_METRICS
    assert trunner.QUANTILE_METRICS == jrunner.QUANTILE_METRICS


def test_load_all_results_skips_missing(tmp_path):
    for i in (1, 3):
        (tmp_path / str(i)).mkdir()
        (tmp_path / str(i) / "results.json").write_text(
            json.dumps({"experiment_id": i}))
    got = trunner.load_all_results(tmp_path, 4)
    assert [r["experiment_id"] for r in got] == [1, 3]


# ---------------------------------------------------------------------------
# run_multiple_experiments
# ---------------------------------------------------------------------------

def test_sequential_engine_writes_contract_and_summary(toy_csv, tmp_path):
    cfg = _cfg(toy_csv)
    out = tmp_path / "run"
    summary = trunner.run_multiple_experiments(cfg, out, engine="sequential",
                                               device="cpu")
    assert summary["n_experiments"] == 3
    for i in (1, 2, 3):
        d = out / "experiments" / str(i)
        for f in ("results.json", "training_history.csv", "predictions.npz",
                  "basis_info.npz"):
            assert (d / f).exists(), f
        r = json.loads((d / "results.json").read_text())
        assert r["experiment_seed"] == 100 + i - 1
        assert np.isfinite(r["test_rmse"])
        assert len(r["training_history"]["train_loss"]) == 4
    stats = json.loads((out / "summary" /
                        "summary_statistics.json").read_text())
    assert set(stats["statistics"]) == set(trunner.AGG_METRICS)
    vals = stats["statistics"]["test_rmse"]
    assert len(vals["values"]) == 3 and len(set(vals["values"])) == 3
    assert vals["min"] <= vals["mean"] <= vals["max"]
    with open(out / "summary" / "all_experiments.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["experiment_id", "experiment_seed"] + trunner.AGG_METRICS
    assert [r[0] for r in rows[1:]] == ["1", "2", "3"]


def test_config_default_device_is_used(toy_csv, tmp_path):
    """No `device` argument: the config's device (here the CPU) runs."""
    cfg = _cfg(toy_csv, n_experiments=1, epochs=2, save_artifacts=False)
    summary = trunner.run_multiple_experiments(cfg, tmp_path / "run")
    assert summary["n_experiments"] == 1


def test_skip_existing_skips_and_id_range_is_honoured(toy_csv, tmp_path):
    cfg = _cfg(toy_csv, epochs=2, save_artifacts=False)
    out = tmp_path / "run"
    first = trunner.run_multiple_experiments(cfg, out, start_exp_id=2,
                                             end_exp_id=2, device="cpu")
    assert first["n_experiments"] == 1
    assert not (out / "experiments" / "1").exists()
    f2 = out / "experiments" / "2" / "results.json"
    t0, stored = f2.stat().st_mtime_ns, json.loads(f2.read_text())
    summary = trunner.run_multiple_experiments(cfg, out, skip_existing=True,
                                               device="cpu")
    assert summary["n_experiments"] == 3
    assert f2.stat().st_mtime_ns == t0
    # the single fit's entry point returns what is stored
    again = texp.run_single_experiment(cfg, 2, out / "experiments" / "2",
                                       device="cpu", skip_existing=True)
    assert again == stored
    # without skip_existing the fit runs again
    trunner.run_multiple_experiments(cfg, out, start_exp_id=2, end_exp_id=2,
                                     device="cpu")
    assert f2.stat().st_mtime_ns != t0


def test_failed_sequential_fit_writes_error_and_the_run_goes_on(
        toy_csv, tmp_path, monkeypatch, capsys):
    real = trunner.run_single_experiment

    def flaky(cfg, i, exp_dir, **kw):
        if i == 2:
            raise RuntimeError("synthetic failure")
        return real(cfg, i, exp_dir, **kw)

    monkeypatch.setattr(trunner, "run_single_experiment", flaky)
    cfg = _cfg(toy_csv, epochs=2, save_artifacts=False)
    out = tmp_path / "run"
    summary = trunner.run_multiple_experiments(cfg, out, device="cpu")
    assert "[FAILED] Experiment 2" in capsys.readouterr().out
    err = (out / "experiments" / "2" / "error.txt").read_text()
    assert "synthetic failure" in err and "Traceback" in err
    assert not (out / "experiments" / "2" / "results.json").exists()
    assert summary["n_experiments"] == 2
    with open(out / "summary" / "all_experiments.csv", newline="") as f:
        assert [r[0] for r in list(csv.reader(f))[1:]] == ["1", "3"]


def test_engines_refused(toy_csv, tmp_path):
    """An unknown engine raises before anything is written. engine='dp'
    runs now: with no process group a fit is data-parallel over one rank,
    the sequential fit bit for bit (two ranks:
    tests/test_torch_data_parallel.py)."""
    cfg = _cfg(toy_csv, n_experiments=2, dropout=0.1)
    with pytest.raises(ValueError, match="Unknown engine"):
        trunner.run_multiple_experiments(cfg, tmp_path, engine="pmap")
    assert not (tmp_path / "experiments").exists()
    dp = trunner.run_multiple_experiments(cfg, tmp_path / "dp", engine="dp",
                                          device="cpu")
    seq = trunner.run_multiple_experiments(cfg, tmp_path / "seq",
                                           device="cpu")
    assert dp["n_experiments"] == seq["n_experiments"] == 2
    for m in ("test_rmse", "valid_rmse", "train_mae"):
        assert dp["statistics"][m]["values"] == seq["statistics"][m]["values"]


def test_nothing_on_disk_gives_no_summary(toy_csv, tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("x")

    monkeypatch.setattr(trunner, "run_single_experiment", boom)
    cfg = _cfg(toy_csv, n_experiments=1)
    assert trunner.run_multiple_experiments(cfg, tmp_path, device="cpu") is None
    assert not (tmp_path / "summary").exists()


# ---------------------------------------------------------------------------
# the accuracy comparer (scripts/port_accuracy_compare.py)
# ---------------------------------------------------------------------------

def _load_comparer():
    import importlib.util
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "scripts"
            / "port_accuracy_compare.py")
    spec = importlib.util.spec_from_file_location("port_accuracy_compare",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_accuracy_comparer_reads_the_runners_summary(tmp_path):
    """The comparer reads what `aggregate_results` writes and states the
    delta of means in the reference run's sigma of the mean."""
    cmp = _load_comparer()
    base = _results("quantile")
    for name, shift in (("ref", 0.0), ("near", 0.001), ("far", 0.5)):
        rs = [dict(r, test_crps=r["test_crps"] + shift,
                   test_rmse=r["test_rmse"] + shift) for r in base]
        trunner.aggregate_results(rs, tmp_path / name / "summary")
    (tmp_path / "ref" / "run_info.json").write_text(json.dumps(
        {"framework": "jax", "engine": "vmap", "hardware": "CPU host",
         "wall_seconds": 1.5}))
    rc = cmp.main([f"{n}={tmp_path / n}" for n in ("ref", "near", "far")]
                  + ["--out", str(tmp_path / "table.md")])
    assert rc == 0
    text = (tmp_path / "table.md").read_text()
    rows, _ = cmp.read_run(tmp_path / "ref")
    assert sorted(rows) == [2025, 2026, 2027, 2028, 2029]
    crps = np.asarray([r["test_crps"] for r in base])
    sig = crps.std() / np.sqrt(5)
    assert f"{0.001 / sig:+.2f} sigma_mean (noise)" in text
    assert f"{0.5 / sig:+.2f} sigma_mean (BEYOND NOISE)" in text
    assert "jax engine vmap on CPU host, wall 1.5 s" in text
    assert repr(base[0]["test_rmse"]) in text
