"""Port parity: ragged-k lanes, covariates and the first layer's routes
(st_dadk_tpu_torch.models.st_interp / .train) against st_dadk_tpu.

A ragged-k lane pads its spatial basis to a shared width k_spatial_pad: the
junk rows start at exactly 0 and phi's junk columns are masked, so the lane
tracks its own-shape run and the junk rows stay 0. The port runs such a lane
through the materialised-phi kernels; on the CPU their wrappers take their
plain PyTorch versions. Tolerances: the padded forward rtol 1e-5 / atol 1e-6
(tests/test_ragged_k.py:114), fit histories rtol 1e-4 (test_torch_fit.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu.models import st_interp as jm
from st_dadk_tpu.train import experiment as jexp
from st_dadk_tpu.train import loop as jloop
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.models import st_interp as tm
from st_dadk_tpu_torch.train import experiment as texp
from st_dadk_tpu_torch.train import loop as tloop
from torch_threads import worker_threads  # noqa: F401

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
HIST_RTOL = 1e-4


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    """The toy field of tests/test_ragged_k.py::toy_csv."""
    d = tmp_path_factory.mktemp("ragged")
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (d / "toy.csv").write_text("\n".join(lines))
    return d / "toy.csv"


def _cfg_dict(toy_csv, **kw):
    """tests/test_ragged_k.py::_cfg (learnable basis, damping, domain,
    movement and sparse-group penalties, cosine LR, clipping), dropout 0
    and the identity batch order so that the two packages agree."""
    base = dict(
        tag="raggedtest", data_file=str(toy_csv),
        k_spatial_centers=[9], k_temporal_centers=[4],
        hidden_dims=[16, 8], dropout=0.0, epochs=3, lr=5e-3,
        batch_size=64, patience=50, warmup_epochs=1, scheduler="cosine",
        grad_clip=10.0, regression_type="mean",
        spatial_learnable=True, gradient_damping=True,
        damping_threshold=0.0, damping_strength=5.0,
        domain_penalty_weight=0.01, movement_penalty_weight=0.001,
        sparsity_penalty_type="sparse_group", sparsity_lambda_l1=1e-4,
        sparsity_lambda_group=1e-4,
        obs_method="site-wise", obs_ratio=0.5, obs_spatial_pattern="uniform",
        split_method="random", train_ratio=0.8, base_seed=100,
        save_artifacts=True, shuffle="none", spatial_init_method="uniform",
        save_plots=False)
    base.update(kw)
    return base


def _jax_pair(k_centers, p=0, seed=0):
    spec = jm.ModelSpec(p=p, k_spatial_centers=tuple(k_centers),
                        k_temporal_centers=(4,), hidden_dims=(8, 6),
                        spatial_learnable=True, use_pallas=False)
    params, consts = jm.init_model(jax.random.PRNGKey(seed), spec)
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return spec, np_tree(params), np_tree(consts)


def _port_spec(spec_j, **kw):
    return tm.ModelSpec(p=spec_j.p, k_spatial_centers=spec_j.k_spatial_centers,
                        k_temporal_centers=spec_j.k_temporal_centers,
                        hidden_dims=spec_j.hidden_dims,
                        spatial_learnable=True, **kw)


def _points(seed, n=37, p=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, 2)).astype(np.float32),
            rng.uniform(size=(n, 1)).astype(np.float32),
            rng.normal(size=(n, p)).astype(np.float32))


def _assert_trees_equal(a, b):
    fa = dict(jax.tree_util.tree_leaves_with_path(a))
    fb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert set(fa) == set(fb)
    for key in fa:
        np.testing.assert_array_equal(np.asarray(fa[key]), np.asarray(fb[key]),
                                      err_msg=jax.tree_util.keystr(key))


# -- (b) pad / strip ----------------------------------------------------------

@pytest.mark.parametrize("p", [0, 2])
def test_pad_and_strip_equal_jax_and_round_trip(p):
    spec_j, params, consts = _jax_pair((9, 16), p=p)
    pad_j = jm.pad_lane_model(spec_j, 40, params, consts)
    pad_t = tm.pad_lane_model(_port_spec(spec_j), 40, params, consts)
    for a, b in zip(pad_t, pad_j):
        _assert_trees_equal(a, b)
    assert pad_t[0]["mlp"]["linear_0"]["w"].shape == (p + 40 + 4, 8)
    assert float(pad_t[1]["spatial_k_mask"].sum()) == 25
    strip_t = tm.strip_lane_padding(_port_spec(spec_j), 40, *pad_t)
    strip_j = jm.strip_lane_padding(spec_j, 40, *pad_j)
    for a, b in zip(strip_t, strip_j):
        _assert_trees_equal(a, b)
    _assert_trees_equal(strip_t[0], params)
    _assert_trees_equal(strip_t[1], consts)


# -- (c) the padded forward ---------------------------------------------------

def test_padded_forward_matches_real_and_jax():
    spec_j, params, consts = _jax_pair((9,), seed=1)
    k_pad = 24
    padded, pconsts = tm.pad_lane_model(_port_spec(spec_j), k_pad, params,
                                        consts)
    spec_pad_j = dataclasses.replace(spec_j, k_spatial_centers=(k_pad,))
    coords, t, _ = _points(2)
    want = np.asarray(jm.forward(spec_pad_j, padded, pconsts, None,
                                 jnp.asarray(coords), jnp.asarray(t)))
    real = tm.from_jax_params(_port_spec(spec_j), params, consts,
                              device="cpu")
    pad_model = tm.from_jax_params(
        _port_spec(spec_pad_j, phi_route=True, padded_lane=True), padded,
        pconsts, device="cpu")
    assert float(pad_model.spatial_k_mask.sum()) == 9
    with torch.no_grad():
        c, tt = torch.as_tensor(coords), torch.as_tensor(t)
        got_pad = pad_model(c, tt).numpy()
        got_real = real(c, tt).numpy()
    np.testing.assert_allclose(got_pad, got_real, rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    np.testing.assert_allclose(got_pad, want, rtol=FWD_RTOL, atol=FWD_ATOL)


# -- (f) covariates -----------------------------------------------------------

@pytest.mark.parametrize("penalty", ["element", "group", "sparse_group"])
def test_covariate_forward_and_sparsity_match_jax(penalty):
    """[X | phi | psi] @ W with p = 2 covariates, and the sparsity penalty
    of the spatial and temporal row blocks after the covariate rows."""
    spec_j, params, consts = _jax_pair((9, 16), p=2, seed=3)
    coords, t, X = _points(4, p=2)
    want = np.asarray(jm.forward(spec_j, params, consts, jnp.asarray(X),
                                 jnp.asarray(coords), jnp.asarray(t)))
    want_pen = jm.sparsity_penalty(spec_j, params, penalty, 1e-3, 1e-2)
    model = tm.from_jax_params(_port_spec(spec_j, phi_route=True), params,
                               consts, device="cpu")
    with torch.no_grad():
        got = model(torch.as_tensor(coords), torch.as_tensor(t),
                    X=torch.as_tensor(X)).numpy()
        pen = model.sparsity_penalty(penalty, 1e-3, 1e-2)
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    for key in ("spatial_penalty", "temporal_penalty", "total_penalty"):
        np.testing.assert_allclose(float(pen[key]), float(want_pen[key]),
                                   rtol=1e-6, err_msg=key)
    with pytest.raises(ValueError, match="covariates"):
        model(torch.as_tensor(coords), torch.as_tensor(t))


# -- (g) routing --------------------------------------------------------------

@pytest.mark.parametrize("override,phi_route,padded", [
    (dict(), False, False),
    (dict(k_spatial_pad=40), True, True),
    (dict(p_covariates=2), True, False),
    (dict(use_pallas_training=True), True, False),
    (dict(use_pallas_training=True, use_fused_training=True), False, False),
    (dict(use_fused_training=True), False, False),
])
def test_spec_routing(override, phi_route, padded):
    """The materialised-phi route for a ragged lane, for covariates and for
    use_pallas_training without use_fused_training (JAX forward :388 before
    _embed :226); the fused route otherwise. Predict takes the fused
    forward with no covariates off a padded lane (JAX loop.py:1348)."""
    cfg = ExperimentConfig.from_dict(dict(k_spatial_centers=[9, 16],
                                          **override))
    spec = tm.spec_from_config(cfg)
    assert spec.phi_route is phi_route
    assert spec.padded_lane is padded
    assert spec.k_spatial_centers == ((40,) if padded else (9, 16))
    assert spec.fused_predict is (cfg.p_covariates == 0 and not padded)
    assert spec.input_dim == cfg.p_covariates + spec.k_spatial + 70


# -- setup, fit and finalize of a ragged lane ---------------------------------

def test_ragged_init_draws_the_unpadded_values(toy_csv):
    d = _cfg_dict(toy_csv, k_spatial_centers=[9, 16])
    real = texp.ExperimentSetup(ExperimentConfig.from_dict(d), 1, "cpu")
    lane = texp.ExperimentSetup(
        ExperimentConfig.from_dict(dict(d, k_spatial_pad=40)), 1, "cpu")
    want = tm.to_jax_params(real.model)
    got = tm.strip_lane_padding(real.spec, 40, tm.to_jax_params(lane.model),
                                tm.model_consts(lane.model))[0]
    _assert_trees_equal(got, want)
    assert lane.model.spec.phi_route
    assert float(lane.model.spatial_k_mask.sum()) == 25


def test_ragged_fit_matches_jax(toy_csv):
    """(e) A ragged lane's fit against the JAX fit of the same padded lane,
    from the JAX init."""
    d = _cfg_dict(toy_csv, k_spatial_centers=[9], k_spatial_pad=25)
    cfg_j, cfg_t = JaxConfig.from_dict(d), ExperimentConfig.from_dict(d)
    setup_j = jexp.ExperimentSetup(cfg_j, 1)
    setup_t = texp.ExperimentSetup(cfg_t, 1, "cpu", defer_model=True)
    setup_t.model = tm.from_jax_params(setup_t.spec, setup_j.params,
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


def test_junk_rows_stay_zero(toy_csv):
    """(d) The padded rows of a lane the port initialised and trained are
    exactly 0: in the serving (EMA) params and in the trained model
    (tests/test_ragged_k.py:179-198)."""
    d = _cfg_dict(toy_csv, k_spatial_centers=[9], k_spatial_pad=25,
                  shuffle="auto", dropout=0.1)
    cfg = ExperimentConfig.from_dict(d)
    setup = texp.ExperimentSetup(cfg, 1, "cpu")
    res = tloop.fit(cfg, setup.spec, setup.model, setup.train_ps,
                    setup.valid_ps, seed=setup.experiment_seed)
    for p in (res.params, tm.to_jax_params(setup.model)):
        assert np.all(p["basis"]["centers"][9:] == 0)
        assert np.all(p["basis"]["log_bandwidths"][9:] == 0)
        w0 = p["mlp"]["linear_0"]["w"]
        assert np.all(w0[9:25] == 0) and not np.all(w0[:9] == 0)
    assert res.center_shift[-1] > 0.0


def test_ragged_lane_tracks_its_own_shape_run(toy_csv, tmp_path):
    """run_single_experiment on a padded lane against the same config
    unpadded (the fused route): metrics within the bar of
    tests/test_ragged_k.py:171, artifacts with the real shapes."""
    d = _cfg_dict(toy_csv, k_spatial_centers=[9, 16], epochs=4)
    res = {}
    for name, extra in (("real", {}), ("lane", dict(k_spatial_pad=40))):
        res[name] = texp.run_single_experiment(dict(d, **extra), 1,
                                               tmp_path / name, device="cpu",
                                               verbose=False)
    for key in ("test_rmse", "valid_rmse", "train_rmse"):
        assert abs(res["lane"][key] - res["real"][key]) < 5e-3, key
    assert res["lane"]["model_parameters"] == res["real"]["model_parameters"]
    info = np.load(tmp_path / "lane" / "basis_info.npz")
    assert info["spatial_centers_final"].shape == (25, 2)
    assert info["spatial_centers_init"].shape == (25, 2)
    final = texp.load_params_npz(tmp_path / "lane" / "model_final.npz")
    assert final["mlp"]["linear_0"]["w"].shape == (25 + 4, 16)
    pred = np.load(tmp_path / "lane" / "predictions.npz")["predictions"]
    assert pred.shape == (12, 40) and np.all(np.isfinite(pred))


# -- ragged-k lanes through the lane engine -------------------------------------

from st_dadk_tpu.train import batch_engine as jbe  # noqa: E402
from st_dadk_tpu_torch.train import batch_engine as tbe  # noqa: E402


@pytest.mark.parametrize("case", ["pad_merges", "unpadded_splits",
                                  "extra_knob_splits", "obs_fields_stack"])
def test_stacking_key_with_pad_equals_jax(toy_csv, case):
    """With `k_spatial_pad`, `k_spatial_centers` leaves the key, as in JAX
    (batch_engine.py:354-356): the cases of tests/test_ragged_k.py:119-140,
    each pair of configs through both packages' keys."""
    a = _cfg_dict(toy_csv, k_spatial_centers=[9], k_spatial_pad=25)
    b = {"pad_merges": dict(a, k_spatial_centers=[16, 9]),
         "unpadded_splits": _cfg_dict(toy_csv, k_spatial_centers=[16, 9]),
         "extra_knob_splits": dict(a, init_gmm_n_init=2),
         "obs_fields_stack": dict(a, obs_ratio=0.3, base_seed=7)}[case]
    same_t = (tbe.stacking_key(ExperimentConfig.from_dict(a))
              == tbe.stacking_key(ExperimentConfig.from_dict(b)))
    same_j = (jbe.stacking_key(JaxConfig.from_dict(a))
              == jbe.stacking_key(JaxConfig.from_dict(b)))
    assert same_t is same_j
    assert same_t is (case in ("pad_merges", "obs_fields_stack"))


def test_ragged_batch_matches_own_shape_runs(toy_csv, tmp_path):
    """tests/test_ragged_k.py:142 for the port: configs of different k as
    padded lanes of one batch against the same configs unpadded through the
    single fit; the JAX bar 5e-3 on the RMSEs, real shapes in the artifacts,
    the real parameter count."""
    k_lists = ([9], [16, 9])
    k_pad = 25
    jobs, seq = [], []
    for j, kl in enumerate(k_lists):
        d = _cfg_dict(toy_csv, k_spatial_centers=list(kl), epochs=4,
                      spatial_init_method="gmm")
        seq.append(texp.run_single_experiment(d, 1, tmp_path / f"seq{j}",
                                              device="cpu", verbose=False))
        jobs.append((ExperimentConfig.from_dict(
            dict(d, k_spatial_pad=k_pad, device="cpu")), 1,
            tmp_path / f"stack{j}"))
    stacked = tbe.run_job_batch(jobs)
    assert len(stacked) == 2
    for j, kl in enumerate(k_lists):
        rs, rq = stacked[j], seq[j]
        for key in ("test_rmse", "valid_rmse", "train_rmse"):
            assert abs(rs[key] - rq[key]) < 5e-3, (key, j)
        assert rs["model_parameters"] == rq["model_parameters"]
        assert rs["stage_timings"]["batch_lanes"] == 2
        info = np.load(tmp_path / f"stack{j}" / "basis_info.npz")
        assert info["spatial_centers_final"].shape == (sum(kl), 2)
        assert info["spatial_centers_init"].shape == (sum(kl), 2)
        # the batched init gave the lane its single fit's centers
        ref = np.load(tmp_path / f"seq{j}" / "basis_info.npz")
        np.testing.assert_allclose(info["spatial_centers_init"],
                                   ref["spatial_centers_init"], atol=1e-5)
        final = texp.load_params_npz(tmp_path / f"stack{j}" /
                                     "model_final.npz")
        assert final["mlp"]["linear_0"]["w"].shape == (sum(kl) + 4, 16)


def test_junk_rows_stay_zero_through_the_lane_engine(toy_csv, tmp_path):
    """tests/test_ragged_k.py:179 for the lane engine, with dropout and
    shuffling on: after clipping, center damping, weight decay and the EMA of
    `fit_lanes`, every lane's padded rows are exactly 0 in the trained model
    and in the serving params, and its real rows are not."""
    k_lists, k_pad = ([9], [16, 9], [25]), 25
    jobs = [(ExperimentConfig.from_dict(dict(
        _cfg_dict(toy_csv, k_spatial_centers=list(kl), k_spatial_pad=k_pad,
                  shuffle="auto", dropout=0.1, epochs=4,
                  spatial_init_method="gmm", weight_decay=1e-2),
        device="cpu")), 1, tmp_path / str(j)) for j, kl in enumerate(k_lists)]
    state = tbe._execute_job_batch(tbe._prepare_job_batch(jobs))
    model = state["setups"][0].model          # lanes were stacked from these
    assert model.spec.padded_lane
    for kl, fit_res, n in zip(k_lists, state["results"], state["n_params"]):
        k = sum(kl)
        p = fit_res.params
        assert np.all(p["basis"]["centers"][k:] == 0)
        assert np.all(p["basis"]["log_bandwidths"][k:] == 0)
        w0 = p["mlp"]["linear_0"]["w"]
        assert w0.shape == (k_pad + 4, 16)
        assert np.all(w0[k:k_pad] == 0) and not np.all(w0[:k] == 0)
        assert fit_res.center_shift[-1] > 0.0
        assert n == 3 * k + (k + 4) * 16 + 16 + 2 * 16 + 16 * 8 + 8 + 16 + 8 + 1
    results = tbe._finalize_job_batch(state)
    assert [r["model_parameters"] for r in results] == state["n_params"]


def test_ragged_batch_matches_jax_run_job_batch(toy_csv, tmp_path,
                                                monkeypatch):
    """A ragged batch of two lanes ([9] and [16, 9] padded to 25) through
    `run_job_batch` of both packages, from the JAX-initialised params,
    dropout 0 and the identity batch order: loss histories within HIST_RTOL
    (the bar of test_fit_lanes_matches_the_jax_vmapped_fit), scores within
    1e-4 relative."""
    k_lists, k_pad = ([9], [16, 9]), 25
    dicts = [_cfg_dict(toy_csv, k_spatial_centers=list(kl),
                       k_spatial_pad=k_pad, use_pallas=False,
                       save_plots=False) for kl in k_lists]
    res_j = jbe.run_job_batch(
        [(JaxConfig.from_dict(d), 1, tmp_path / f"jax{j}")
         for j, d in enumerate(dicts)], verbose=False, epochs_chunk=3)

    finish = texp.ExperimentSetup.finish_model

    def finish_from_jax(self, centers, bandwidths):
        finish(self, centers, bandwidths)        # the real parameter count
        sj = jexp.ExperimentSetup(JaxConfig.from_dict(self.cfg.to_dict()),
                                  self.experiment_id)
        self.model = tm.from_jax_params(self.spec, sj.params, sj.consts,
                                        device="cpu")

    monkeypatch.setattr(texp.ExperimentSetup, "finish_model", finish_from_jax)
    res_t = tbe.run_job_batch(
        [(ExperimentConfig.from_dict(dict(d, device="cpu")), 1,
          tmp_path / f"port{j}") for j, d in enumerate(dicts)])
    for rj, rt in zip(res_j, res_t):
        for key in ("train_loss", "val_loss", "val_rmse"):
            np.testing.assert_allclose(rt["training_history"][key],
                                       rj["training_history"][key],
                                       rtol=HIST_RTOL, err_msg=key)
        for key in ("test_rmse", "valid_rmse", "train_rmse"):
            assert rt[key] == pytest.approx(rj[key], rel=1e-4), key
        assert rt["model_parameters"] == rj["model_parameters"]
