"""The slice end to end: setup, fit and finalize of st_dadk_tpu_torch against
st_dadk_tpu on a toy field with the bench workload's structure at small
widths (k 4+9, k_t 5, hidden 32-16, 5 quantiles, learnable Wendland basis
unfreezing at epoch 1, dropout 0, identity batch order)."""
import json

import jax
import numpy as np
import pytest

from st_dadk_tpu.bench_workload import bench_workload as jax_bench
from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu.train import experiment as jexp
from st_dadk_tpu.train import loop as jloop
from st_dadk_tpu_torch.bench_workload import bench_workload as torch_bench
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.models.st_interp import from_jax_params
from st_dadk_tpu_torch.train import experiment as texp
from st_dadk_tpu_torch.train import loop as tloop
from torch_threads import worker_threads  # noqa: F401

# The two fits run the same float32 arithmetic in another order (the JAX
# fit inside one compiled scan); rounding differences grow through 3 epochs
# x 12 AdamW steps, whose normalised updates amplify small-gradient noise.
# Measured gap on this toy fit: <= 5e-7 relative. 1e-4 leaves 200x margin
# and is still ~1000x below the epoch-to-epoch change of the losses.
HIST_RTOL = 1e-4
# test metrics from the same (JAX-trained) params: only the forward's
# float32 summation order differs
METRIC_RTOL = 1e-5

OVERRIDES = dict(
    k_spatial_centers=[4, 9], k_temporal_centers=[5], hidden_dims=[32, 16],
    dropout=0.0, epochs=3, warmup_epochs=1, basis_unfreeze_epoch=1,
    basis_lr_rampup_epochs=2, patience=50, obs_ratio=0.5, shuffle="none",
    spatial_init_method="uniform")


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


@pytest.fixture(scope="module")
def both(toy_csv):
    """JAX and port setups of experiment 1 with the same params and
    centers: JAX init_model params carried across by from_jax_params."""
    d = dict(OVERRIDES, data_file=str(toy_csv))
    cfg_j = JaxConfig.from_dict(jax_bench(**d))
    cfg_t = ExperimentConfig.from_dict(torch_bench(**d))
    setup_j = jexp.ExperimentSetup(cfg_j, 1)
    setup_t = texp.ExperimentSetup(cfg_t, 1, "cpu", defer_model=True)
    setup_t.model = from_jax_params(setup_t.spec, setup_j.params,
                                    setup_j.consts, device="cpu")
    return cfg_j, cfg_t, setup_j, setup_t


@pytest.fixture(scope="module")
def fits(both):
    cfg_j, cfg_t, setup_j, setup_t = both
    res_j = jloop.fit(cfg_j, setup_j.spec, setup_j.params, setup_j.consts,
                      setup_j.train_ps, setup_j.valid_ps,
                      seed=setup_j.experiment_seed)
    res_t = tloop.fit(cfg_t, setup_t.spec, setup_t.model, setup_t.train_ps,
                      setup_t.valid_ps, seed=setup_t.experiment_seed)
    return res_j, res_t


def test_data_and_masks_identical(both):
    _, _, sj, st = both
    np.testing.assert_array_equal(sj.z_full, st.z_full)
    np.testing.assert_array_equal(sj.coords, st.coords)
    for name in ("obs_mask", "train_mask", "valid_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(sj, name), getattr(st, name),
                                      err_msg=name)
    for name in ("train_ps", "valid_ps", "test_ps"):
        a, b = getattr(sj, name), getattr(st, name)
        for f in ("coords", "t", "y", "w"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("split_method,obs_method",
                         [("site-wise", "site-wise"), ("random", "random")])
def test_masks_identical_other_designs(toy_csv, split_method, obs_method):
    d = dict(OVERRIDES, data_file=str(toy_csv), split_method=split_method,
             obs_method=obs_method, obs_spatial_pattern="uniform")
    sj = jexp.ExperimentSetup(JaxConfig.from_dict(jax_bench(**d)), 3,
                              defer_model=True)
    st = texp.ExperimentSetup(ExperimentConfig.from_dict(torch_bench(**d)), 3,
                              "cpu", defer_model=True)
    for name in ("obs_mask", "train_mask", "valid_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(sj, name), getattr(st, name),
                                      err_msg=name)


def test_three_epoch_history_matches_jax(fits):
    res_j, res_t = fits
    assert res_t.n_epochs_run == res_j.n_epochs_run == 3
    for key in ("train_loss", "val_loss", "val_rmse"):
        np.testing.assert_allclose(res_t.history[key], res_j.history[key],
                                   rtol=HIST_RTOL, err_msg=key)
    np.testing.assert_array_equal(res_t.history["lr"], res_j.history["lr"])
    assert res_t.best_val == pytest.approx(res_j.best_val, rel=HIST_RTOL)
    # the basis is frozen in epoch 1 and moves once unfrozen
    assert res_t.center_shift[0] == 0.0 and res_t.center_shift[-1] > 0.0
    np.testing.assert_allclose(res_t.params["basis"]["centers"],
                               np.asarray(res_j.params["basis"]["centers"]),
                               atol=1e-5)


def test_finalize_from_jax_trained_params_matches_jax(both, fits, tmp_path):
    """predict + metrics of the port's finalize, fed the JAX fit's params,
    against the JAX finalize of the same fit."""
    cfg_j, cfg_t, setup_j, setup_t = both
    res_j, res_t = fits
    want = jexp.finalize_experiment(cfg_j, setup_j, res_j, tmp_path / "j",
                                    1.0, write_artifacts=False)
    carried = res_t._replace(params=jax.tree_util.tree_map(np.asarray,
                                                           res_j.params))
    got = texp.finalize_experiment(cfg_t, setup_t, carried, tmp_path / "t",
                                   1.0)
    for key in ("test_rmse", "test_crps", "valid_rmse", "valid_crps",
                "train_rmse", "train_crps", "test_mae", "test_check_loss"):
        assert got[key] == pytest.approx(want[key], rel=METRIC_RTOL), key
    written = json.loads((tmp_path / "t" / "results.json").read_text())
    missing = set(want) - set(written) - {"_split_predictions"}
    assert not missing, missing
    header = (tmp_path / "t" / "training_history.csv").read_text().splitlines()
    assert header[0] == "epoch,train_loss,val_loss,val_rmse,lr"
    assert len(header) == 1 + 3


def test_run_single_experiment_gmm_shuffled_with_dropout(toy_csv, tmp_path):
    """The user entry point with the GMM init, random batch order and
    dropout on: the contract files, finite metrics, one step per batch."""
    d = dict(OVERRIDES, data_file=str(toy_csv), spatial_init_method="gmm",
             dropout=0.1, shuffle="auto", epochs=4, save_artifacts=True)
    res = texp.run_single_experiment(torch_bench(**d), 1, tmp_path,
                                     device="cpu", verbose=False)
    for f in ("results.json", "training_history.csv", "model_final.npz",
              "model_best.npz", "predictions.npz", "basis_info.npz"):
        assert (tmp_path / f).exists(), f
    assert np.isfinite(res["test_rmse"]) and np.isfinite(res["test_crps"])
    assert res["n_steps"] == 4 * 12        # 192 train points, batch 16
    assert res["n_points"]["test"] == 240
    pred = np.load(tmp_path / "predictions.npz")["predictions"]
    assert pred.shape == (12, 40) and np.all(np.isfinite(pred))


def test_fit_scores_runs_chip_smokes_fits():
    """fit_scores.py, which compares two trees' scores bitwise on the card,
    runs the fits chip_smoke.py runs, and refuses to run without a card."""
    import importlib.util
    from pathlib import Path

    from st_dadk_tpu_torch import fit_scores

    path = Path(fit_scores.__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert fit_scores.EPOCHS == smoke.EPOCHS
    assert fit_scores.LANE_CENTERS == smoke.LANE_CENTERS
    assert fit_scores.LANE_PAD == smoke.LANE_PAD
    assert fit_scores.FITS["ragged lane"]["k_spatial_pad"] == smoke.LANE_PAD
    if not fit_scores.torch.cuda.is_available():
        assert fit_scores.main([]) == 2
