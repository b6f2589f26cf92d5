"""The lane engine's on-device metrics finalize
(`train/batch_engine.py::_device_metrics` / `_batched_eval_device`), on the
CPU, where the kernel wrappers run their plain versions.

- Against JAX's `_device_metrics_program` (st_dadk_tpu/train/
  batch_engine.py:100-151) on the same params (JAX's init carried across),
  masks and field, with non-finite truth points and two predict chunks, in
  the two regression modes that reach it (a per-tau quantile lane needs the
  dense field and takes the host path): rtol 1e-5.
- Against the port's host path `_batched_eval` (dense predict pulled to the
  host, metrics by `metrics_from_preds`): rtol 1e-5, the same bar; the
  device takes the host's arithmetic and sums in float64.
- The path is taken exactly where JAX takes it (no artifacts, figures or
  per-tau lanes, one process), the serving params then stay on the device,
  and a failing device evaluation prints JAX's warning, is counted in
  `eval_fallbacks`, pulls the params and scores each lane on its own
  (tests/test_batch_engine.py:94-117); a failing host evaluation raises.
"""
import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.models import st_interp as tm
from st_dadk_tpu_torch.train import batch_engine as tbe
from st_dadk_tpu_torch.train import experiment as texp
from st_dadk_tpu_torch.train.loop import FitResult
from torch_threads import worker_threads  # noqa: F401

RTOL = 1e-5
CHUNK = 256                      # 480 grid points: two chunks, one partial
LEVELS = [0.05, 0.25, 0.5, 0.75, 0.95]
MODES = {"multi-quantile": dict(regression_type="multi-quantile",
                                quantile_levels=LEVELS),
         "mean": dict(regression_type="mean"),
         "quantile": dict(regression_type="quantile",
                          quantile_levels=[0.3])}

_BASE = dict(
    tag="devmetrics", k_spatial_centers=[9], k_temporal_centers=[4],
    hidden_dims=[16, 8], dropout=0.0, epochs=2, lr=5e-3, batch_size=64,
    patience=50, warmup_epochs=1, scheduler="cosine", grad_clip=10.0,
    obs_method="site-wise", obs_ratio=0.5, obs_spatial_pattern="uniform",
    split_method="random", train_ratio=0.8, n_experiments=2, base_seed=100,
    save_artifacts=False, save_plots=False, eval_chunk=CHUNK,
    spatial_init_method="uniform")


def _dict(csv, **kw):
    return dict(_BASE, data_file=str(csv), device="cpu", **kw)


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    """The toy field of tests/test_torch_batch_engine.py."""
    d = tmp_path_factory.mktemp("devmetrics")
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (d / "toy.csv").write_text("\n".join(lines))
    return d / "toy.csv"


def _labels(setups):
    return np.stack([s.train_mask.ravel().astype(np.int8)
                     + s.valid_mask.ravel().astype(np.int8) * 2
                     + s.test_mask.ravel().astype(np.int8) * 3
                     for s in setups])


@pytest.mark.parametrize("mode", ["mean", "multi-quantile"])
def test_device_metrics_match_jax_program(toy_csv, mode):
    import jax
    import jax.numpy as jnp

    from st_dadk_tpu.config import ExperimentConfig as JaxConfig
    from st_dadk_tpu.dataio.arrays import dense_grid_points
    from st_dadk_tpu.train import batch_engine as jbe
    from st_dadk_tpu.train import experiment as jexp

    d = _dict(toy_csv, **MODES[mode])
    cfg_j, cfg_t = JaxConfig.from_dict(d), ExperimentConfig.from_dict(d)
    setups = [jexp.ExperimentSetup(cfg_j, i) for i in (1, 2)]
    s0 = setups[0]
    coords, t = dense_grid_points(s0.T, s0.coords)
    n = coords.shape[0]
    n_pad = -(-n // CHUNK) * CHUNK
    coords_p = np.zeros((n_pad, 2), np.float32)
    coords_p[:n] = coords
    t_p = np.zeros((n_pad, 1), np.float32)
    t_p[:n] = t.reshape(n, 1)
    z = s0.z_full.ravel().astype(np.float32).copy()
    z[::17] = np.nan                       # points with no truth drop out
    labels = _labels(setups)
    taus = np.asarray([0.5, 0.5], np.float32)   # read by quantile only
    stack = lambda trees: jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *trees)
    fn = jbe._device_metrics_program(
        s0.spec, list(cfg_j.quantile_levels), cfg_j.regression_type,
        n_pad // CHUNK, n, CHUNK)
    want = np.asarray(fn(stack([s.params for s in setups]),
                         stack([s.consts for s in setups]),
                         jnp.asarray(coords_p), jnp.asarray(t_p),
                         jnp.asarray(z), jnp.asarray(labels),
                         jnp.asarray(taus)))

    spec = tm.spec_from_config(cfg_t)
    model = tm.stack_lane_models([
        tm.from_jax_params(spec, s.params, s.consts, device="cpu")
        for s in setups])
    params = {k: v.detach() for k, v in model.named_parameters()}
    got = tbe._device_metrics(
        cfg_t, model, params, torch.as_tensor(coords, dtype=torch.float32),
        torch.as_tensor(t.reshape(n, 1), dtype=torch.float32),
        torch.as_tensor(z), torch.as_tensor(labels), CHUNK).numpy()
    assert got.shape == want.shape == (2, 3, {"multi-quantile": 4,
                                              "mean": 2}[mode])
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _port_lanes(cfg):
    setups = [texp.ExperimentSetup(cfg, i, "cpu") for i in (1, 2)]
    fits = [FitResult(params=texp.to_jax_params(s.model), history={},
                      best_val=0.0, n_epochs_run=0, stopped_early=False,
                      center_shift=np.asarray([]), n_steps=0, n_val_chunks=1,
                      timings={}) for s in setups]
    model = tm.stack_lane_models([s.model for s in setups])
    return setups, fits, model


@pytest.mark.parametrize("mode", ["multi-quantile", "mean"])
def test_device_metrics_match_the_host_path(toy_csv, mode):
    cfg = ExperimentConfig.from_dict(_dict(toy_csv, **MODES[mode]))
    setups, fits, model = _port_lanes(cfg)
    params = {k: v.detach() for k, v in model.named_parameters()}
    got = tbe._batched_eval_device(cfg, setups, model, params)
    want = tbe._batched_eval(cfg, setups, fits)
    for g, w in zip(got, want):
        for split in ("train_metrics", "val_metrics", "test_metrics"):
            assert set(g[split]) == set(w[split])
            for m, v in w[split].items():
                assert g[split][m] == pytest.approx(v, rel=RTOL), (split, m)
        assert "all_predictions" not in g


def test_the_path_is_taken_where_jax_takes_it(toy_csv, monkeypatch):
    cfg = ExperimentConfig.from_dict(_dict(toy_csv))
    setups = [texp.ExperimentSetup(cfg, i, "cpu", defer_model=True)
              for i in (1, 2)]
    assert tbe._device_eval(setups)
    for kw in (dict(save_artifacts=True), dict(save_plots=True),
               dict(regression_type="quantile", quantile_levels=[0.5])):
        other = [texp.ExperimentSetup(ExperimentConfig.from_dict(
            _dict(toy_csv, **kw)), 1, "cpu", defer_model=True)]
        assert not tbe._device_eval(setups + other), kw
    monkeypatch.setattr(tbe, "process_info", lambda: (2, 0))
    assert not tbe._device_eval(setups)


def _run(cfg, tmp, monkeypatch=None):
    """run_experiment_batch, with the batch's state as finalize saw it and
    whether its params were still on the device when finalize began."""
    seen = {}
    finalize = tbe._finalize_job_batch

    def spy(state):
        seen["on_device"] = state["results"][0].params is None
        seen["state"] = state
        return finalize(state)
    tbe._finalize_job_batch = spy
    try:
        res = tbe.run_experiment_batch(cfg, [1, 2], tmp)
    finally:
        tbe._finalize_job_batch = finalize
    return res, seen


@pytest.fixture(scope="module")
def device_run(toy_csv, tmp_path_factory):
    """A metrics-only batch (no artifacts, no figures) with the host
    evaluation made to fail, so that only the device path can score it."""
    host = tbe._batched_eval

    def no_host(*a, **kw):
        raise AssertionError("the host evaluation ran")
    tbe._batched_eval = no_host
    try:
        cfg = ExperimentConfig.from_dict(_dict(toy_csv,
                                               **MODES["multi-quantile"]))
        return (cfg,) + _run(cfg, tmp_path_factory.mktemp("device"))
    finally:
        tbe._batched_eval = host


def test_metrics_only_batch_keeps_params_on_device(toy_csv, tmp_path,
                                                   device_run):
    """Artifacts and figures off: the device metrics score the batch (the
    host path is never called) and no param leaves the device; with
    artifacts on, the host path and pulled params, and the same scores."""
    _, dev, seen = device_run
    assert seen["on_device"]
    assert all(r.params is None for r in seen["state"]["results"])
    assert [r["model_parameters"] for r in dev] == seen["state"]["n_params"]
    arts, seen = _run(ExperimentConfig.from_dict(_dict(
        toy_csv, save_artifacts=True, **MODES["multi-quantile"])),
        tmp_path / "a")
    assert not seen["on_device"]
    assert (tmp_path / "a" / "1" / "model_final.npz").exists()
    for a, b in zip(dev, arts):
        for k in ("test_rmse", "test_crps", "valid_mae", "train_check_loss"):
            assert a[k] == pytest.approx(b[k], rel=RTOL), k


def test_failed_device_eval_falls_back_and_repulls(tmp_path, monkeypatch,
                                                   capsys, device_run):
    cfg, want, _ = device_run

    def boom(*a, **kw):
        raise RuntimeError("synthetic eval failure")
    monkeypatch.setattr(tbe, "_batched_eval_device", boom)
    before = tbe.eval_fallbacks
    got, seen = _run(cfg, tmp_path / "f")
    assert "falling back per-lane" in capsys.readouterr().out
    assert tbe.eval_fallbacks == before + 1
    assert seen["on_device"]
    assert all(r.params is not None for r in seen["state"]["results"])
    assert len(got) == 2
    for a, b in zip(got, want):
        for k in ("test_rmse", "test_crps", "valid_rmse"):
            assert np.isfinite(a[k])
            assert a[k] == pytest.approx(b[k], rel=RTOL), k


def test_failed_host_eval_raises(toy_csv, tmp_path, monkeypatch):
    """The host path has no fallback: with artifacts on, a failing dense
    predict raises out of the batch, and nothing counts a fallback."""
    cfg = ExperimentConfig.from_dict(_dict(toy_csv, save_artifacts=True,
                                           **MODES["mean"]))

    def boom(*a, **kw):
        raise RuntimeError("synthetic eval failure")
    monkeypatch.setattr(tbe, "_batched_eval", boom)
    before = tbe.eval_fallbacks
    with pytest.raises(RuntimeError, match="synthetic eval failure"):
        tbe.run_experiment_batch(cfg, [1, 2], tmp_path)
    assert tbe.eval_fallbacks == before


def test_a_non_finite_history_pulls_the_params(toy_csv, tmp_path):
    """A lane whose history holds a NaN has its NaN diagnostics written,
    which read its params: they are pulled, the device metrics still score
    the batch (JAX :1529-1541)."""
    cfg = ExperimentConfig.from_dict(_dict(toy_csv, **MODES["multi-quantile"]))
    jobs = [(cfg, i, tmp_path / str(i)) for i in (1, 2)]
    state = tbe._execute_job_batch(tbe._prepare_job_batch(jobs))
    assert all(r.params is None for r in state["results"])
    r0 = state["results"][0]
    r0.history["train_loss"][0] = np.nan
    res = tbe._finalize_job_batch(state)
    assert all(r.params is not None for r in state["results"])
    assert (tmp_path / "1" / "nan_diagnostics.json").exists()
    assert np.isfinite(res[0]["test_crps"])
