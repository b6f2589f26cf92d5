"""Port parity: the STInterp forward, the composite training loss and its
transformed gradients, with JAX-initialised params carried across by
from_jax_params (st_dadk_tpu_torch.models / .train.loop vs st_dadk_tpu)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu.models import st_interp as jm
from st_dadk_tpu.train import loop as jloop
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.models import st_interp as tm
from st_dadk_tpu_torch.train import experiment as texp
from st_dadk_tpu_torch.train import loop as tloop
from torch_threads import worker_threads  # noqa: F401

FWD_ATOL = 5e-5                   # test_pallas_fused.py:59
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5  # test_pallas_fused.py:134-136


def _points(seed, n=96):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, 2)).astype(np.float32),
            rng.uniform(size=(n, 1)).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32))


@pytest.mark.parametrize("learnable,delta", [(False, False), (True, True),
                                             (True, False)])
def test_forward_matches_jax(learnable, delta):
    d = dict(k_spatial_centers=[25, 81], k_temporal_centers=[4, 6],
             hidden_dims=[32, 16], dropout=0.1, spatial_learnable=learnable,
             regression_type="multi-quantile" if delta else "mean",
             quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
             use_delta_reparameterization=delta)
    spec_j = jm.spec_from_config(JaxConfig.from_dict(d), use_pallas=False)
    params, consts = jm.init_model(jax.random.PRNGKey(0), spec_j)
    coords, t, _ = _points(1)
    want = np.asarray(jm.forward(spec_j, params, consts, None,
                                 jnp.asarray(coords), jnp.asarray(t),
                                 train=False))
    model = tm.from_jax_params(tm.spec_from_config(ExperimentConfig.from_dict(d)),
                               params, consts, device="cpu")
    with torch.no_grad():
        got = model(torch.as_tensor(coords), torch.as_tensor(t)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


def test_params_round_trip():
    spec = tm.ModelSpec(k_spatial_centers=(4, 9), k_temporal_centers=(5,),
                        hidden_dims=(8, 4), spatial_learnable=True,
                        output_dim=3, use_delta_reparameterization=True)
    model = tm.init_model(torch.Generator().manual_seed(0), spec,
                          device="cpu")
    tree = tm.to_jax_params(model)
    assert tree["mlp"]["linear_0"]["w"].shape == (4 + 9 + 5, 8)
    assert tree["mlp"]["delta"].shape == (3, 5)
    assert set(tree["basis"]) == {"centers", "log_bandwidths"}
    copy = tm.STInterp(spec, model.spatial_centers_init.numpy(),
                       model.spatial_bandwidths_init.numpy())
    tm.load_jax_params(copy, tree)
    for a, b in zip(model.parameters(), copy.parameters()):
        assert torch.equal(a, b)
    # same init distributions as the JAX init_model (torch Linear default)
    w0 = tree["mlp"]["linear_0"]["w"]
    assert np.abs(w0).max() <= 1 / np.sqrt(18)


def test_training_loss_and_transformed_grads_match_jax():
    """Composite loss (multi-quantile, delta head with non-crossing penalty,
    domain, movement and sparse-group penalties), dropout 0, then damping
    of center gradients and per-group clipping."""
    d = dict(k_spatial_centers=[25, 81], k_temporal_centers=[4],
             hidden_dims=[32, 16], dropout=0.0, epochs=1,
             regression_type="multi-quantile",
             quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
             use_delta_reparameterization=True, non_crossing_lambda=1.0,
             spatial_learnable=True, domain_penalty_weight=0.01,
             movement_penalty_weight=0.001,
             sparsity_penalty_type="sparse_group",
             sparsity_lambda_l1=1e-4, sparsity_lambda_group=1e-4,
             gradient_damping=True, damping_threshold=0.02,
             damping_strength=5.0, grad_clip=0.5)
    cfg_j = JaxConfig.from_dict(d)
    spec_j = jm.spec_from_config(cfg_j, use_pallas=False)
    params, consts = jm.init_model(jax.random.PRNGKey(0), spec_j)
    # move the centers off their init (and a few outside [0,1]^2) so the
    # damping and the domain penalty act
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
                                 torch.as_tensor(w), train=True, generator=None)
    loss_t.backward()
    tloop._transform_grads(spec_lt, model)

    assert np.isclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    flat_j = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
              jax.tree_util.tree_leaves_with_path(g_j)}
    flat_t = {name: p.grad.numpy() for name, p in model.named_parameters()}
    assert len(flat_j) == len(flat_t)
    for name, g in flat_t.items():
        key = "".join(f"['{part}']" for part in name.split("."))
        np.testing.assert_allclose(g, flat_j[key], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("override,entry", [(dict(train_dtype="fp16"), "spec"),
                                            (dict(p_covariates=2), "fit")])
def test_unported_configs_raise(override, entry, tmp_path):
    """A trunk dtype that is neither 'auto', 'f32' nor 'bf16' has no spec
    (JAX would train it in float32 without a word; the bf16 trunk itself
    is tests/test_torch_bf16.py's); a fit with covariates is refused, since
    the JAX fit feeds none (its model takes X: test_torch_ragged_k.py)."""
    cfg = ExperimentConfig.from_dict(override)
    with pytest.raises(ValueError if entry == "spec"
                       else NotImplementedError):
        if entry == "spec":
            tm.spec_from_config(cfg)
        else:
            texp.run_single_experiment(cfg, 1, tmp_path, device="cpu",
                                       verbose=False)
