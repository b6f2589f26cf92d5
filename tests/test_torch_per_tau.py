"""Per-tau quantile fits of the port (`regression_type: quantile`: one model
a level) against the JAX package: the check loss, a fit of one tau from the
same initial params, the quantile_<q>/ tree with its aggregated results and
CRPS, and per-tau lanes of the lane engine against their single fits."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.bench_workload import bench_workload as jax_bench
from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu.ops import losses as jl
from st_dadk_tpu.train import experiment as jexp
from st_dadk_tpu.train import loop as jloop
from st_dadk_tpu_torch.bench_workload import bench_workload as torch_bench
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.models.st_interp import from_jax_params
from st_dadk_tpu_torch.ops import losses as tl
from st_dadk_tpu_torch.train import batch_engine as tbe
from st_dadk_tpu_torch.train import experiment as texp
from st_dadk_tpu_torch.train import loop as tloop
from st_dadk_tpu_torch.train.runner import run_multiple_experiments
from torch_threads import worker_threads  # noqa: F401

# the bars of tests/test_torch_fit.py
HIST_RTOL, METRIC_RTOL = 1e-4, 1e-5
# a lane against its single fit at dropout 0 without shuffling: the bar of
# tests/test_torch_batch_engine.py (bmm for mm, the same order of batches)
LANE_RTOL = 1e-4
LEVELS = [0.1, 0.5, 0.9]
# the aggregated results.json of a per-tau experiment (JAX
# st_dadk_tpu/train/experiment.py:201-222)
AGG_KEYS = {"experiment_id", "regression_type", "quantile_levels",
            "quantile_results", "total_time_seconds"} | {
    f"{s}_{m}" for s in ("train", "valid", "test")
    for m in ("crps", "check_loss", "mse", "rmse", "mae")}

OVERRIDES = dict(
    k_spatial_centers=[4, 9], k_temporal_centers=[5], hidden_dims=[32, 16],
    dropout=0.0, epochs=3, warmup_epochs=1, basis_unfreeze_epoch=1,
    basis_lr_rampup_epochs=2, patience=50, obs_ratio=0.5, shuffle="none",
    spatial_init_method="uniform", regression_type="quantile",
    quantile_levels=LEVELS)


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    """The toy field of tests/test_batch_engine.py::toy_csv."""
    d = tmp_path_factory.mktemp("toy")
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (d / "toy.csv").write_text("\n".join(lines))
    return d / "toy.csv"


def _cfg(toy_csv, **kw):
    return ExperimentConfig.from_dict(torch_bench(**dict(
        OVERRIDES, data_file=str(toy_csv), device="cpu", **kw)))


@pytest.mark.parametrize("tau", [0.1, 0.5, 0.9])
def test_check_loss_single_and_lane_forms_equal_jax(tau):
    rng = np.random.default_rng(1)
    yp, yt = (rng.normal(size=(3, 64, 1)).astype(np.float32)
              for _ in range(2))
    w = (rng.uniform(size=(3, 64)) > 0.2).astype(np.float32)
    for i in range(3):
        want = float(jl.quantile_loss(jnp.asarray(yp[i]), jnp.asarray(yt[i]),
                                      tau, jnp.asarray(w[i])))
        got = float(tl.quantile_loss(torch.as_tensor(yp[i]),
                                     torch.as_tensor(yt[i]), tau,
                                     torch.as_tensor(w[i])))
        assert got == pytest.approx(want, rel=1e-6)
    lanes = tl.quantile_loss_lanes(torch.as_tensor(yp), torch.as_tensor(yt),
                                   tau, torch.as_tensor(w))
    # a tau a lane, as lane data
    taus = torch.tensor([tau, 0.25, 0.75])
    mixed = tl.quantile_loss_lanes(torch.as_tensor(yp), torch.as_tensor(yt),
                                   taus, torch.as_tensor(w))
    for i, t in enumerate(taus.tolist()):
        want = float(jl.quantile_loss(jnp.asarray(yp[i]), jnp.asarray(yt[i]),
                                      t, jnp.asarray(w[i])))
        assert float(mixed[i]) == pytest.approx(want, rel=1e-6)
        if i == 0:
            assert float(lanes[0]) == float(mixed[0])


def test_one_tau_fit_from_jax_params_matches_jax(toy_csv):
    """A quantile fit of tau 0.1 from the JAX package's initial params:
    loss histories (the check loss drives training and validation) within
    the bars of tests/test_torch_fit.py."""
    d = dict(OVERRIDES, data_file=str(toy_csv), current_quantile=0.1)
    cfg_j = JaxConfig.from_dict(jax_bench(**d))
    cfg_t = ExperimentConfig.from_dict(torch_bench(**d))
    setup_j = jexp.ExperimentSetup(cfg_j, 1)
    setup_t = texp.ExperimentSetup(cfg_t, 1, "cpu", defer_model=True)
    setup_t.model = from_jax_params(setup_t.spec, setup_j.params,
                                    setup_j.consts, device="cpu")
    res_j = jloop.fit(cfg_j, setup_j.spec, setup_j.params, setup_j.consts,
                      setup_j.train_ps, setup_j.valid_ps,
                      seed=setup_j.experiment_seed)
    res_t = tloop.fit(cfg_t, setup_t.spec, setup_t.model, setup_t.train_ps,
                      setup_t.valid_ps, seed=setup_t.experiment_seed)
    assert res_t.n_epochs_run == res_j.n_epochs_run == 3
    for key in ("train_loss", "val_loss", "val_rmse"):
        np.testing.assert_allclose(res_t.history[key], res_j.history[key],
                                   rtol=HIST_RTOL, err_msg=key)
    assert res_t.best_val == pytest.approx(res_j.best_val, rel=HIST_RTOL)
    # the check loss of the JAX-trained params on the test points
    model = from_jax_params(setup_t.spec, res_j.params,
                            setup_j.consts, device="cpu")
    got, _ = texp.evaluate_pointset(cfg_t, model, setup_t.test_ps)
    want = jexp.metrics_from_preds(
        cfg_j, np.asarray(jloop.predict(setup_j.spec, res_j.params,
                                        setup_j.consts,
                                        setup_j.test_ps.coords,
                                        setup_j.test_ps.t)),
        setup_j.test_ps.y)
    assert set(got) == set(want)
    for m in want:
        assert got[m] == pytest.approx(want[m], rel=METRIC_RTOL), m


@pytest.fixture(scope="module")
def per_tau_run(toy_csv, tmp_path_factory):
    out = tmp_path_factory.mktemp("per_tau")
    cfg = _cfg(toy_csv, epochs=2, save_artifacts=True)
    r = texp.run_single_experiment(cfg, 1, out, device="cpu", verbose=False)
    return cfg, out, r


def test_the_quantile_tree_and_aggregated_results(per_tau_run):
    cfg, out, r = per_tau_run
    on_disk = json.loads((out / "results.json").read_text())
    assert set(on_disk) == AGG_KEYS and on_disk == json.loads(json.dumps(r))
    assert on_disk["quantile_levels"] == LEVELS
    assert sorted(on_disk["quantile_results"]) == [str(q) for q in LEVELS]
    for q in LEVELS:
        qd = out / f"quantile_{q}"
        for f in ("results.json", "training_history.csv", "predictions.npz",
                  "basis_info.npz", "model_final.npz", "model_best.npz"):
            assert (qd / f).exists(), (q, f)
        rq = json.loads((qd / "results.json").read_text())
        assert rq["quantile_level"] == q and rq["regression_type"] == "quantile"
        assert rq["test_mse"] == rq["test_check_loss"]
        assert on_disk["quantile_results"][str(q)] == rq
    # the reference's quirks: *_mse is the mean check loss, *_rmse its root
    for s in ("train", "valid", "test"):
        mean_check = float(np.mean([on_disk["quantile_results"][str(q)][
            f"{s}_check_loss"] for q in LEVELS]))
        assert on_disk[f"{s}_check_loss"] == on_disk[f"{s}_mse"] == mean_check
        assert on_disk[f"{s}_rmse"] == float(np.sqrt(mean_check))


def test_aggregated_crps_equals_jax_compute_crps(per_tau_run):
    _, out, r = per_tau_run
    for split in ("train", "valid", "test"):
        preds, true = {}, None
        for q in LEVELS:
            d = np.load(out / f"quantile_{q}" / "predictions.npz")
            mask = d[f"{split}_mask"]
            preds[q], true = d["predictions"][mask], d["true"][mask]
        assert r[f"{split}_crps"] == pytest.approx(
            jl.compute_crps(preds, true), rel=1e-12)


def test_skip_existing_reloads_the_tau_models(per_tau_run):
    cfg, out, r = per_tau_run
    stamps = {q: (out / f"quantile_{q}" / "results.json").stat().st_mtime_ns
              for q in LEVELS}
    (out / "results.json").unlink()
    again = texp.run_single_experiment(cfg, 1, out, device="cpu",
                                       verbose=False, skip_existing=True)
    assert json.loads(json.dumps(again)) == json.loads(json.dumps(r))
    for q in LEVELS:
        assert (out / f"quantile_{q}" / "results.json").stat().st_mtime_ns \
            == stamps[q]


def test_one_level_is_one_fit_of_that_tau(toy_csv, tmp_path):
    r = texp.run_single_experiment(_cfg(toy_csv, epochs=1,
                                        quantile_levels=[0.25]),
                                   1, tmp_path, device="cpu", verbose=False)
    assert r["quantile_level"] == 0.25 and not any(tmp_path.glob("quantile_*"))


def test_per_tau_lanes_equal_their_single_fits(toy_csv, tmp_path):
    """Experiments x taus as lanes (three taus in a batch: tau is lane
    data) against each tau's single fit of the same seed, and the runner's
    summary of both engines."""
    cfg = _cfg(toy_csv, n_experiments=2)
    seq = run_multiple_experiments(cfg, tmp_path / "seq", device="cpu")
    lanes = run_multiple_experiments(cfg, tmp_path / "vmap", engine="vmap",
                                     device="cpu")
    for i in (1, 2):
        for q in LEVELS:
            a, b = (json.loads((tmp_path / e / "experiments" / str(i) /
                                f"quantile_{q}" / "results.json").read_text())
                    for e in ("vmap", "seq"))
            assert a["experiment_seed"] == b["experiment_seed"]
            for key in ("test_check_loss", "valid_check_loss", "test_mae"):
                assert a[key] == pytest.approx(b[key], rel=LANE_RTOL), (i, q)
            np.testing.assert_allclose(a["training_history"]["val_loss"],
                                       b["training_history"]["val_loss"],
                                       rtol=LANE_RTOL)
    for s in (seq, lanes):
        assert s["n_experiments"] == 2
        assert {"test_crps", "test_check_loss"} <= set(s["statistics"])
    np.testing.assert_allclose(lanes["statistics"]["test_crps"]["values"],
                               seq["statistics"]["test_crps"]["values"],
                               rtol=LANE_RTOL)


def test_a_batch_of_one_tau_trains_on_it_as_a_float(toy_csv, tmp_path):
    """Lanes of one tau (unset: the first level) share it as a float."""
    cfg = _cfg(toy_csv, epochs=1, quantile_levels=[0.9])
    res = tbe.run_job_batch([(cfg, 1, tmp_path / "a"), (cfg, 2, tmp_path / "b")])
    assert [r["quantile_level"] for r in res] == [0.9, 0.9]
    assert all("_split_predictions" not in r for r in res)
