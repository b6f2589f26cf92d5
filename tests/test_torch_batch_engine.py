"""The port's lane engine (st_dadk_tpu_torch.train.batch_engine) on a toy
field on the CPU: the counterparts of tests/test_batch_engine.py, lane
stacking, the threaded batch pipeline and what the engine refuses."""
import csv
import json

import numpy as np
import pytest
import torch

from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu.train import batch_engine as jbe
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.train import batch_engine as tbe
from st_dadk_tpu_torch.train import experiment as texp
from st_dadk_tpu_torch.train.loop import FitResult
from st_dadk_tpu_torch.train.runner import run_multiple_experiments
from torch_threads import worker_threads  # noqa: F401

_BASE = dict(
    tag="batchtest", k_spatial_centers=[9], k_temporal_centers=[4],
    hidden_dims=[16, 8], dropout=0.0, epochs=8, lr=5e-3, batch_size=64,
    patience=50, warmup_epochs=1, scheduler="cosine", grad_clip=10.0,
    regression_type="mean", obs_method="site-wise", obs_ratio=0.5,
    obs_spatial_pattern="uniform", split_method="random", train_ratio=0.8,
    n_experiments=4, base_seed=100, save_artifacts=True, save_plots=False)


def _cfg(toy_dir, **kw):
    """The config of tests/test_batch_engine.py::_cfg, on the CPU."""
    return ExperimentConfig.from_dict(dict(
        _BASE, data_file=str(toy_dir / "toy.csv"), device="cpu", **kw))


def _write_toy(path, seed=0, sites=40, times=12):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(sites, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, times + 1):
        for s in range(sites):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    path.write_text("\n".join(lines))


@pytest.fixture
def toy_csv(tmp_path):
    _write_toy(tmp_path / "toy.csv")
    return tmp_path


def test_runs_and_writes_contract(toy_csv, tmp_path):
    cfg = _cfg(toy_csv)
    exp_dir = tmp_path / "experiments"
    results = tbe.run_experiment_batch(cfg, [1, 2, 3, 4], exp_dir)
    assert len(results) == 4
    for i in (1, 2, 3, 4):
        d = exp_dir / str(i)
        for f in ("results.json", "training_history.csv", "predictions.npz",
                  "basis_info.npz", "model_final.npz", "model_best.npz"):
            assert (d / f).exists(), f
        r = json.loads((d / "results.json").read_text())
        assert np.isfinite(r["test_rmse"])
        assert len(r["training_history"]["train_loss"]) == 8
        assert r["experiment_seed"] == 100 + i - 1
        assert r["experiment_id"] == i
        assert r["stage_timings"]["batch_lanes"] == 4
        pred = np.load(d / "predictions.npz")["predictions"]
        assert pred.shape == (12, 40) and np.all(np.isfinite(pred))
        header = (d / "training_history.csv").read_text().splitlines()
        assert header[0] == "epoch,train_loss,val_loss,val_rmse,lr"
        assert len(header) == 1 + 8


def test_lanes_differ_by_seed(toy_csv, tmp_path):
    results = tbe.run_experiment_batch(_cfg(toy_csv), [1, 2], tmp_path / "e")
    # different seeds -> different masks and inits -> different metrics
    assert results[0]["test_rmse"] != results[1]["test_rmse"]


def test_matches_sequential_engine_closely(toy_csv, tmp_path):
    """A lane against the single fit of its seed: the same masks, init and
    (dropout 0, a shuffle seeded alike but drawn in another order) training
    up to the batch order, so the final metrics agree closely. The bar is
    the JAX test's, rtol 0.05."""
    cfg = _cfg(toy_csv, n_experiments=1)
    r_seq = texp.run_single_experiment(cfg, 1, tmp_path / "seq",
                                       device="cpu", verbose=False)
    r_bat = tbe.run_experiment_batch(cfg, [1], tmp_path / "bat")[0]
    assert np.isclose(r_seq["test_rmse"], r_bat["test_rmse"], rtol=0.05)
    assert r_seq["experiment_seed"] == r_bat["experiment_seed"]
    missing = set(r_seq) - set(r_bat)
    assert not missing, missing


def test_lane_equals_sequential_fit_without_shuffling(toy_csv, tmp_path):
    """With the identity batch order the lane and the single fit run the
    same arithmetic (bmm for mm): scores within 1e-4 relative, which is
    ~100x the gap measured here and far below seed-to-seed spread."""
    cfg = _cfg(toy_csv, n_experiments=1, shuffle="none")
    r_seq = texp.run_single_experiment(cfg, 1, tmp_path / "seq",
                                       device="cpu", verbose=False)
    r_bat = tbe.run_experiment_batch(cfg, [1], tmp_path / "bat")[0]
    for key in ("test_rmse", "valid_rmse", "train_rmse", "test_mae"):
        assert r_bat[key] == pytest.approx(r_seq[key], rel=1e-4), key
    np.testing.assert_allclose(r_bat["training_history"]["val_loss"],
                               r_seq["training_history"]["val_loss"],
                               rtol=1e-4)
    assert r_bat["n_steps"] == r_seq["n_steps"]


def test_runner_vmap_engine_and_aggregation(toy_csv, tmp_path):
    cfg = _cfg(toy_csv)
    out = tmp_path / "run"
    summary = run_multiple_experiments(cfg, out, engine="vmap", device="cpu")
    assert summary["n_experiments"] == 4
    assert (out / "summary" / "summary_statistics.json").exists()
    stats = summary["statistics"]["test_rmse"]
    assert len(stats["values"]) == 4
    assert stats["min"] <= stats["mean"] <= stats["max"]
    with open(out / "summary" / "all_experiments.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0][:2] == ["experiment_id", "experiment_seed"]
    assert [r[1] for r in rows[1:]] == ["100", "101", "102", "103"]


def test_skip_existing(toy_csv, tmp_path):
    cfg = _cfg(toy_csv, n_experiments=2)
    out = tmp_path / "sk"
    tbe.run_experiment_batch(cfg, [1, 2], out)
    t0 = (out / "1" / "results.json").stat().st_mtime_ns
    assert tbe.run_experiment_batch(cfg, [1, 2], out, skip_existing=True) == []
    assert (out / "1" / "results.json").stat().st_mtime_ns == t0
    # only the missing lane runs
    res = tbe.run_experiment_batch(cfg, [1, 2, 3], out, skip_existing=True)
    assert [r["experiment_id"] for r in res] == [3]
    assert (out / "1" / "results.json").stat().st_mtime_ns == t0


def test_stacked_lanes_with_different_batch_counts(toy_csv, tmp_path):
    """Config-level stacking with obs_ratio 0.3 beside 0.9: different real
    batch counts a lane (tests/test_batch_engine.py:145-157)."""
    cfg_lo, cfg_hi = _cfg(toy_csv, obs_ratio=0.3), _cfg(toy_csv, obs_ratio=0.9)
    assert tbe.stacking_key(cfg_lo) == tbe.stacking_key(cfg_hi)
    jobs = [(cfg_lo, 1, tmp_path / "lo"), (cfg_hi, 1, tmp_path / "hi")]
    results = tbe.run_job_batch(jobs)
    assert len(results) == 2
    assert results[0]["n_steps"] < results[1]["n_steps"]
    assert results[0]["n_points"]["train"] < results[1]["n_points"]["train"]
    for r in results:
        assert np.isfinite(r["test_rmse"])
        assert np.isfinite(r["training_history"]["train_loss"]).all()


def test_lanes_of_different_data_files(toy_csv, tmp_path):
    """Lanes may read different files of one shape; each is evaluated
    against its own field."""
    _write_toy(toy_csv / "other.csv", seed=5)
    a = _cfg(toy_csv)
    b = a.replace(data_file=str(toy_csv / "other.csv"))
    res = tbe.run_job_batch([(a, 1, tmp_path / "a"), (b, 1, tmp_path / "b")])
    true_a = np.load(tmp_path / "a" / "predictions.npz")["true"]
    true_b = np.load(tmp_path / "b" / "predictions.npz")["true"]
    assert not np.array_equal(true_a, true_b)
    assert all(np.isfinite(r["test_rmse"]) for r in res)
    _write_toy(toy_csv / "wide.csv", seed=5, sites=30)
    c = a.replace(data_file=str(toy_csv / "wide.csv"))
    with pytest.raises(ValueError, match="shapes differ"):
        tbe.run_job_batch([(a, 1, tmp_path / "a2"), (c, 1, tmp_path / "c")])


def test_delta_head_lanes(toy_csv, tmp_path):
    cfg = _cfg(toy_csv, regression_type="multi-quantile",
               quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
               use_delta_reparameterization=True, non_crossing_lambda=1.0,
               spatial_learnable=True, spatial_init_method="gmm",
               gradient_damping=True, n_experiments=2)
    results = tbe.run_experiment_batch(cfg, [1, 2], tmp_path / "mq")
    for r in results:
        assert "test_crps" in r and np.isfinite(r["test_crps"])
        assert r["quantile_levels"] == [0.05, 0.25, 0.5, 0.75, 0.95]
        assert len(r["basis_center_shift"]) == 8


def test_wider_job_list_runs_as_consecutive_batches(toy_csv, tmp_path,
                                                    monkeypatch):
    """A list wider than the lane width goes through the pipeline
    (`run_job_batches`) in batches of the lane width, the tail at its own
    width; a list that fits runs as one `run_job_batch`."""
    widths, streams = [], []
    real_exec, real_stream = tbe._execute_job_batch, tbe.run_job_batches
    monkeypatch.setattr(tbe, "_execute_job_batch",
                        lambda prep, **kw: widths.append(len(prep["setups"]))
                        or real_exec(prep, **kw))
    monkeypatch.setattr(tbe, "run_job_batches",
                        lambda batches, **kw: streams.append(
                            [len(b) for b in batches])
                        or real_stream(batches, **kw))
    cfg = _cfg(toy_csv, epochs=2, save_artifacts=False, lanes_per_device=2)
    res = tbe.run_experiment_batch(cfg, [1, 2, 3, 4, 5], tmp_path / "e")
    assert widths == [2, 2, 1] and streams == [[2, 2, 1]]
    assert [r["experiment_id"] for r in res] == [1, 2, 3, 4, 5]
    tbe.run_experiment_batch(cfg, [1, 2], tmp_path / "f")
    assert widths == [2, 2, 1, 2] and len(streams) == 1
    assert tbe.lane_width(_cfg(toy_csv)) == tbe.LANES_PER_DEVICE
    with pytest.raises(ValueError, match="lanes_per_device"):
        tbe.lane_width(_cfg(toy_csv, lanes_per_device=0))


def test_batched_eval_equals_the_single_fits_evaluation(toy_csv):
    """The lane engine's metrics come from one dense predict of the T x S
    grid, the single fit's from its point sets: the same points and the
    same forward, so the bar is float32 summation order in the forward."""
    cfg = _cfg(toy_csv, regression_type="multi-quantile",
               quantile_levels=[0.1, 0.5, 0.9])
    setups = [texp.ExperimentSetup(cfg, i, "cpu") for i in (1, 2)]
    fits = [FitResult(params=texp.to_jax_params(s.model), history={},
                      best_val=0.0, n_epochs_run=0, stopped_early=False,
                      center_shift=np.asarray([]), n_steps=0, n_val_chunks=1,
                      timings={}) for s in setups]
    got = tbe._batched_eval(cfg, setups, fits)
    for s, lane in zip(setups, got):
        for key, ps in (("train_metrics", s.train_ps),
                        ("val_metrics", s.valid_ps),
                        ("test_metrics", s.test_ps)):
            want, _ = texp.evaluate_pointset(cfg, s.model, ps)
            assert set(lane[key]) == set(want)
            for m, v in want.items():
                assert lane[key][m] == pytest.approx(v, rel=1e-5), (key, m)
        assert lane["all_predictions"].shape == (s.T, s.S)


def test_stacking_key_and_lr_tables_equal_jax(toy_csv):
    """The keys that may differ between lanes are the JAX engine's, and the
    per-lane LR tables are equal element by element."""
    # the JAX list whole: the keys that are fields there and `extra`
    # here ('config_id', 'save_plots', ...) stay out of the key too
    assert tbe._STACKABLE_KEYS == set(jbe._STACKABLE_KEYS)
    assert tbe.stacking_key(_cfg(toy_csv, config_id=1)) == \
        tbe.stacking_key(_cfg(toy_csv, config_id=2))
    a = _cfg(toy_csv)
    assert tbe.stacking_key(a) == tbe.stacking_key(
        a.replace(base_seed=7, obs_ratio=0.9, data_file="x.csv"))
    assert tbe.stacking_key(a) != tbe.stacking_key(a.replace(lr=1e-3))
    assert tbe.stacking_key(a) != tbe.stacking_key(
        _cfg(toy_csv, shuffle="none"))
    with pytest.raises(ValueError, match="not stackable"):
        tbe.run_job_batch([(a, 1, toy_csv / "a"),
                           (a.replace(lr=1e-3), 1, toy_csv / "b")])

    cfg_j = JaxConfig.from_dict(dict(_BASE, data_file="x.csv",
                                     use_pallas=False, save_plots=False))

    class _Data:
        def __init__(self, b):
            self.n_batches = np.asarray(b, np.int32)

    want, want_rec = jbe._lane_lr_tables(cfg_j, [_Data(3), _Data(5), _Data(3)],
                                         5)
    got, got_rec = tbe._lane_lr_tables(a, [3, 5, 3], 5)
    assert got.shape == (3, 8, 5, 2) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for x, y in zip(got_rec, want_rec):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["per_tau", "ragged_k", "mesh"])
def test_what_the_engine_refuses(toy_csv, tmp_path, case):
    if case == "per_tau":
        # a positive case now: one lane a (experiment, tau) in
        # <i>/quantile_<q>/, then each experiment's aggregated results.json
        cfg = _cfg(toy_csv, regression_type="quantile",
                   quantile_levels=[0.1, 0.5, 0.9], epochs=2)
        assert tbe.is_per_tau(cfg)
        res = tbe.run_experiment_batch(cfg, [1, 2], tmp_path)
        assert [r["experiment_id"] for r in res] == [1, 2]
        for i in (1, 2):
            for q in (0.1, 0.5, 0.9):
                d = tmp_path / str(i) / f"quantile_{q}"
                assert (d / "predictions.npz").exists()
                assert json.loads((d / "results.json").read_text())[
                    "quantile_level"] == q
            r = json.loads((tmp_path / str(i) / "results.json").read_text())
            assert r["quantile_levels"] == [0.1, 0.5, 0.9]
            assert np.isfinite(r["test_crps"])
        return
    elif case == "ragged_k":
        # the positive case of this list: a padded config runs as lanes and
        # is written at its real shapes
        cfg = _cfg(toy_csv, k_spatial_pad=16, spatial_learnable=True,
                   epochs=2)
        res = tbe.run_experiment_batch(cfg, [1, 2], tmp_path)
        assert [r["experiment_id"] for r in res] == [1, 2]
        for i in (1, 2):
            info = np.load(tmp_path / str(i) / "basis_info.npz")
            assert info["spatial_centers_final"].shape == (9, 2)
        # what a ragged batch still refuses: a pad narrower than a lane
        with pytest.raises(ValueError, match="k_pad"):
            tbe.run_experiment_batch(cfg.replace(k_spatial_pad=4), [3],
                                     tmp_path)
        return
    else:
        # a rank mesh runs now (one process: it owns every lane; lanes
        # across processes: tests/test_torch_multiprocess_cluster.py; lanes
        # nested over exp x data: tests/test_torch_nested_lanes.py); what
        # stays refused is a data axis of two ranks with no group joined,
        # and an axis the engine has no use for
        from st_dadk_tpu_torch.parallel.mesh import make_mesh
        from st_dadk_tpu_torch.parallel.multihost import RankDevice
        ranks = [RankDevice(0, 0), RankDevice(1, 1)]
        nested = make_mesh({"exp": 1, "data": 2}, ranks)
        with pytest.raises(ValueError, match="no process group"):
            tbe.run_experiment_batch(_cfg(toy_csv), [1, 2], tmp_path,
                                     mesh=nested)
        with pytest.raises(ValueError, match="no use for"):
            tbe.run_experiment_batch(_cfg(toy_csv), [1, 2], tmp_path,
                                     mesh=make_mesh({"exp": 1, "model": 2},
                                                    ranks))
        assert not any(tmp_path.glob("*/results.json"))
        res = tbe.run_experiment_batch(_cfg(toy_csv, epochs=2), [1, 2],
                                       tmp_path, mesh=make_mesh())
        assert [r["experiment_id"] for r in res] == [1, 2]
        return
    assert not any(tmp_path.glob("*/results.json"))


def test_entry_points_default_to_the_configs_device(toy_csv, tmp_path):
    """No `device` argument: the config's device runs (the card by default;
    here the config names the CPU)."""
    cfg = _cfg(toy_csv, epochs=2, save_artifacts=False, n_experiments=2)
    res = tbe.run_experiment_batch(cfg, [1, 2], tmp_path)
    assert len(res) == 2
    assert ExperimentConfig().device == "cuda"
    assert not torch.cuda.is_available() or res[0]["config"]["device"] == "cpu"


# ---------------------------------------------------------------------------
# The threaded batch pipeline
# ---------------------------------------------------------------------------

_COMPARED = ("experiment_id", "experiment_seed", "metrics",
             "training_history", "n_steps", "n_epochs_run",
             "basis_center_shift", "model_parameters")


def _pipeline_jobs(toy_csv, out, width=2, **kw):
    """6 jobs of a learnable, GMM-initialised config: 3 batches of 2."""
    cfg = _cfg(toy_csv, epochs=3, spatial_learnable=True,
               spatial_init_method="gmm", gradient_damping=True,
               lanes_per_device=width, **kw)
    return cfg, [(cfg, i, out / str(i)) for i in range(1, 7)]


@pytest.mark.parametrize("width", [2, 4])
def test_run_job_batches_equals_serial_batches(toy_csv, tmp_path, width):
    """The pipelined stream gives, bit for bit, what the same batches give
    one after another: results and saved params. At width 4 the tail batch
    holds 2 lanes and runs at that width (nothing pads it)."""
    cfg, jobs = _pipeline_jobs(toy_csv, tmp_path / "pipe", width)
    piped = tbe.run_lane_jobs(jobs, cfg)
    _, jobs_s = _pipeline_jobs(toy_csv, tmp_path / "serial", width)
    serial = []
    for a in range(0, 6, width):
        serial += tbe.run_job_batch(jobs_s[a:a + width])
    assert [r["experiment_id"] for r in piped] == [1, 2, 3, 4, 5, 6]
    for i, (rp, rs) in enumerate(zip(piped, serial)):
        for key in _COMPARED:
            assert rp[key] == rs[key], key
        assert rp["stage_timings"]["batch_lanes"] == min(width,
                                                         6 - i // width * width)
    for i in range(1, 7):
        a = np.load(tmp_path / "pipe" / str(i) / "model_final.npz")
        b = np.load(tmp_path / "serial" / str(i) / "model_final.npz")
        assert set(a.files) == set(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_skip_existing_through_the_pipeline(toy_csv, tmp_path):
    cfg, jobs = _pipeline_jobs(toy_csv, tmp_path, save_artifacts=False)
    first = tbe.run_job_batches([jobs[2:4]])
    stamp = (tmp_path / "3" / "results.json").stat().st_mtime_ns
    res = tbe.run_lane_jobs(jobs, cfg, skip_existing=True)
    # the middle batch is on disk: it neither runs nor returns
    assert [r["experiment_id"] for r in res] == [1, 2, 5, 6]
    assert (tmp_path / "3" / "results.json").stat().st_mtime_ns == stamp
    assert tbe.run_lane_jobs(jobs, cfg, skip_existing=True) == []
    assert [r["experiment_id"] for r in first] == [3, 4]


@pytest.mark.parametrize("where", ["prepare", "finalize"])
def test_pipeline_thread_exceptions_reach_the_caller(toy_csv, tmp_path,
                                                     monkeypatch, where):
    cfg, jobs = _pipeline_jobs(toy_csv, tmp_path, save_artifacts=False)
    name = f"_{where}_job_batch"
    real, calls = getattr(tbe, name), []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError(f"boom in {where}")
        return real(*a, **kw)

    monkeypatch.setattr(tbe, name, failing)
    with pytest.raises(RuntimeError, match=f"boom in {where}"):
        tbe.run_lane_jobs(jobs, cfg)
    # the first batch was written before the failure
    assert (tmp_path / "1" / "results.json").exists()
    assert not (tmp_path / "5" / "results.json").exists() or where == "finalize"
