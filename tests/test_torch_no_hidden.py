"""A model with no hidden layer (`hidden_dims: []`) on the port against the
JAX package, where [phi, psi] feed the head directly (JAX st_interp.py:89,
:388-389): the spec and its route, the forward and the training loss's
gradients with carried params (the bars of tests/test_torch_model.py:
forward atol 5e-5, gradients rtol 5e-4 / atol 5e-5), the lanes module, and a
3-epoch fit from JAX's params with JAX's hash-shuffle multipliers handed
across, its loss histories within rtol 1e-4 of JAX's (the bar of
tests/test_torch_shuffle.py: the same batches, float32 sums in another
order). Such a model has no trunk, so no dropout is drawn: the paired fit
keeps the config's dropout 0.1 and still shares every random stream."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.bench_workload import bench_workload as jax_bench
from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu.models import st_interp as jm
from st_dadk_tpu.train import experiment as jexp
from st_dadk_tpu.train import loop as jloop
from st_dadk_tpu_torch.bench_workload import bench_workload as torch_bench
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.models import st_interp as tm
from st_dadk_tpu_torch.train import experiment as texp
from st_dadk_tpu_torch.train import loop as tloop
from st_dadk_tpu_torch.train.runner import run_multiple_experiments

FWD_ATOL = 5e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
HIST_RTOL = 1e-4

QUANTILES = [0.05, 0.25, 0.5, 0.75, 0.95]


def _cfg_dict(**kw):
    return {**dict(k_spatial_centers=[25, 81], k_temporal_centers=[4, 6],
                   hidden_dims=[], dropout=0.1,
                   regression_type="multi-quantile",
                   quantile_levels=QUANTILES), **kw}


def _points(seed, n=96):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, 2)).astype(np.float32),
            rng.uniform(size=(n, 1)).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32))


def test_spec_routes_to_phi_and_bf16_still_raises():
    cfg = ExperimentConfig.from_dict(_cfg_dict())
    spec = tm.spec_from_config(cfg)
    assert spec.hidden_dims == () and spec.phi_route
    assert not spec.fused_predict
    assert spec.last_hidden_dim == spec.input_dim == 106 + 10
    jspec = jm.spec_from_config(JaxConfig.from_dict(_cfg_dict()),
                                use_pallas=False)
    assert spec.last_hidden_dim == jspec.last_hidden_dim
    with pytest.raises(NotImplementedError, match="float32"):
        tm.spec_from_config(cfg.replace(train_dtype="bf16"))
    model = tm.init_model(torch.Generator().manual_seed(0), spec,
                          device="cpu")
    with pytest.raises(ValueError, match="no first layer"):
        model(*(torch.as_tensor(a) for a in _points(0)[:2]), fused=True)


@pytest.mark.parametrize("learnable,delta", [(False, False), (True, True),
                                             (True, False)])
def test_forward_matches_jax(learnable, delta):
    d = _cfg_dict(spatial_learnable=learnable,
                  use_delta_reparameterization=delta,
                  regression_type="multi-quantile" if delta else "mean")
    spec_j = jm.spec_from_config(JaxConfig.from_dict(d), use_pallas=False)
    params, consts = jm.init_model(jax.random.PRNGKey(0), spec_j)
    assert "linear_0" not in params["mlp"]
    coords, t, _ = _points(1)
    want = np.asarray(jm.forward(spec_j, params, consts, None,
                                 jnp.asarray(coords), jnp.asarray(t)))
    spec_t = tm.spec_from_config(ExperimentConfig.from_dict(d))
    model = tm.from_jax_params(spec_t, params, consts, device="cpu")
    head = model.mlp.delta if delta else model.mlp.out.w
    assert head.shape[-1 if delta else 0] == spec_t.input_dim + (1 if delta
                                                                 else 0)
    with torch.no_grad():
        got = model(torch.as_tensor(coords), torch.as_tensor(t)).numpy()
        # no trunk: train mode draws no dropout and is the eval forward
        gen = torch.Generator().manual_seed(3)
        state = gen.get_state()
        train = model(torch.as_tensor(coords), torch.as_tensor(t),
                      train=True, generator=gen).numpy()
    assert torch.equal(gen.get_state(), state)
    np.testing.assert_array_equal(train, got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    # the tree carries back
    back = tm.to_jax_params(model)
    flat_j = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
              jax.tree_util.tree_leaves_with_path(params)}
    flat_t = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_leaves_with_path(back)}
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k])


def test_loss_gradients_match_jax():
    """The multi-quantile loss with the non-crossing, domain and movement
    penalties, then the damping and the per-group clipping."""
    d = _cfg_dict(dropout=0.0, epochs=1, use_delta_reparameterization=True,
                  non_crossing_lambda=1.0, spatial_learnable=True,
                  domain_penalty_weight=0.01, movement_penalty_weight=0.001,
                  gradient_damping=True, damping_threshold=0.02,
                  damping_strength=5.0, grad_clip=0.5)
    cfg_j = JaxConfig.from_dict(d)
    spec_j = jm.spec_from_config(cfg_j, use_pallas=False)
    params, consts = jm.init_model(jax.random.PRNGKey(1), spec_j)
    rng = np.random.default_rng(5)
    params["basis"]["centers"] = params["basis"]["centers"] + jnp.asarray(
        rng.normal(scale=0.05, size=(106, 2)), jnp.float32)
    coords, t, y = _points(3, 128)
    w = np.ones(128, np.float32)
    w[-20:] = 0.0
    spec_lj = jloop.LoopSpec.from_config(cfg_j, spec_j, 128, 1, 128, 1)

    @jax.jit
    def loss_and_grads(p):
        loss, g = jax.value_and_grad(
            lambda q: jloop.training_loss(spec_lj, q, consts,
                                          jnp.asarray(coords), jnp.asarray(t),
                                          jnp.asarray(y), jnp.asarray(w),
                                          train=True, rng=None))(p)
        return loss, jloop._transform_grads(spec_lj, g, p, consts)

    loss_j, g_j = loss_and_grads(params)
    cfg_t = ExperimentConfig.from_dict(d)
    spec_t = tm.spec_from_config(cfg_t)
    model = tm.from_jax_params(spec_t, params, consts, device="cpu")
    spec_lt = tloop.LoopSpec.from_config(cfg_t, spec_t, 128, 1, 128, 1)
    loss_t = tloop.training_loss(spec_lt, model, torch.as_tensor(coords),
                                 torch.as_tensor(t), torch.as_tensor(y),
                                 torch.as_tensor(w), train=True,
                                 generator=None)
    loss_t.backward()
    tloop._transform_grads(spec_lt, model)
    assert np.isclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    flat_j = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
              jax.tree_util.tree_leaves_with_path(g_j)}
    flat_t = {name: p.grad.numpy() for name, p in model.named_parameters()}
    assert len(flat_j) == len(flat_t) == 3
    for name, g in flat_t.items():
        key = "".join(f"['{part}']" for part in name.split("."))
        np.testing.assert_allclose(g, flat_j[key], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_sparsity_penalty_needs_a_first_layer():
    spec = tm.spec_from_config(ExperimentConfig.from_dict(_cfg_dict()))
    model = tm.init_model(torch.Generator().manual_seed(0), spec,
                          device="cpu")
    assert float(model.sparsity_penalty("none", 0.1, 0.1)
                 ["total_penalty"]) == 0.0
    with pytest.raises(ValueError, match="first hidden layer"):
        model.sparsity_penalty("sparse_group", 0.1, 0.1)
    lanes = tm.stack_lane_models([model, model])
    assert lanes.sparsity_penalty("none", 0.1, 0.1)["total_penalty"].shape \
        == (2,)
    with pytest.raises(ValueError, match="first hidden layer"):
        lanes.sparsity_penalty("group", 0.1, 0.1)


def test_lanes_equal_their_single_models():
    spec = tm.spec_from_config(ExperimentConfig.from_dict(
        _cfg_dict(spatial_learnable=True)))
    models = [tm.init_model(torch.Generator().manual_seed(s), spec,
                            device="cpu") for s in range(3)]
    lanes = tm.stack_lane_models(models)
    coords, t, _ = _points(4, 50)
    c = torch.as_tensor(coords).expand(3, -1, -1).contiguous()
    tt = torch.as_tensor(t).expand(3, -1, -1).contiguous()
    gen = torch.Generator().manual_seed(0)
    out = lanes(c, tt, train=True, generator=gen)
    assert torch.equal(gen.get_state(),
                       torch.Generator().manual_seed(0).get_state())
    for i, m in enumerate(models):
        one = m(torch.as_tensor(coords), torch.as_tensor(t))
        torch.testing.assert_close(out[i], one, rtol=0, atol=1e-6)
    out.sum().backward()
    assert lanes.basis.centers.grad.abs().sum() > 0


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    """The toy field of tests/test_torch_shuffle.py."""
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


OVERRIDES = dict(
    k_spatial_centers=[4, 9], k_temporal_centers=[5], hidden_dims=[],
    epochs=3, warmup_epochs=1, basis_unfreeze_epoch=1,
    basis_lr_rampup_epochs=2, patience=50, obs_ratio=0.5,
    spatial_init_method="uniform", sparsity_penalty_type="none",
    shuffle="auto")


def test_three_epoch_fit_matches_jax(toy_csv, monkeypatch):
    """Three epochs of the bench schedule (dropout 0.1, no trunk to drop
    from) from JAX's params, the port handed JAX's per-epoch multipliers:
    the loss histories follow JAX's, and so do the serving params."""
    d = dict(OVERRIDES, data_file=str(toy_csv))
    cfg_j = JaxConfig.from_dict(jax_bench(**d))
    cfg_t = ExperimentConfig.from_dict(torch_bench(**d))
    assert cfg_t.dropout == 0.1 and cfg_t.hidden_dims == []
    sj = jexp.ExperimentSetup(cfg_j, 1)
    st = texp.ExperimentSetup(cfg_t, 1, "cpu", defer_model=True)
    st.model = tm.from_jax_params(st.spec, sj.params, sj.consts, device="cpu")
    res_j = jloop.fit(cfg_j, sj.spec, sj.params, sj.consts, sj.train_ps,
                      sj.valid_ps, seed=sj.experiment_seed)
    root = jax.random.PRNGKey(sj.experiment_seed)
    epochs = iter(range(cfg_t.epochs))

    def jax_epoch_multipliers(cap, generator, device):
        perm_key, _ = jax.random.split(jax.random.fold_in(root, next(epochs)))
        return torch.as_tensor(np.array(jax.random.randint(
            perm_key, (4,), 0, tloop.hash_width(cap), dtype=jnp.int32)),
            dtype=torch.int64, device=device)

    monkeypatch.setattr(tloop, "hash_multipliers", jax_epoch_multipliers)
    res_t = tloop.fit(cfg_t, st.spec, st.model, st.train_ps, st.valid_ps,
                      seed=st.experiment_seed)
    assert res_t.n_epochs_run == res_j.n_epochs_run == 3
    for key in ("train_loss", "val_loss", "val_rmse"):
        np.testing.assert_allclose(res_t.history[key], res_j.history[key],
                                   rtol=HIST_RTOL, err_msg=key)
    flat_j = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
              jax.tree_util.tree_leaves_with_path(res_j.params)}
    flat_t = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_leaves_with_path(res_t.params)}
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_runner_vmap_fits_lanes_without_a_hidden_layer(toy_csv, tmp_path):
    """Two seeds as lanes through the runner: the results contract, the
    parameter count of the head on [phi, psi] plus the basis."""
    cfg = torch_bench(**dict(OVERRIDES, data_file=str(toy_csv), epochs=2,
                             n_experiments=2, save_plots=False))
    summary = run_multiple_experiments(cfg, tmp_path, engine="vmap",
                                       device="cpu")
    assert summary["n_experiments"] == 2
    for i in (1, 2):
        import json
        r = json.loads((tmp_path / "experiments" / str(i) / "results.json")
                       .read_text())
        assert np.isfinite(r["test_crps"])
        k, k_t, q = 13, 5, len(cfg["quantile_levels"])
        assert r["model_parameters"] == (k + k_t + 1) * q + 3 * k
