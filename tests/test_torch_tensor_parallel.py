"""Tensor parallelism over the basis axis (`parallel/tensor_parallel.py`) in
gloo children on the CPU, against the port's unsharded model and fit and
the JAX package's TP forward (tests/test_tensor_parallel.py, whose bars
these are): the forward at 2 and 4 ranks (atol 5e-5), one train step
(loss rtol 1e-5, gradients and updates atol 5e-5), `fit_tp` against `fit`
(rtol 0.02 / atol 5e-4), pads inert over several steps, and JAX's
`to_tp_params` output carried into the port's TP layout. k = 25 leaves pad
rows at both widths (26, 28). One launch of children a width."""
import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.dataio.arrays import PointSet
from st_dadk_tpu_torch.models.st_interp import (ModelSpec, from_jax_params,
                                                init_model, model_consts,
                                                to_jax_params)
from st_dadk_tpu_torch.parallel import tensor_parallel as ttp
from torch_threads import worker_threads  # noqa: F401

SPECS = {
    "fixed": ModelSpec(k_spatial_centers=(9, 16), k_temporal_centers=(4,),
                       hidden_dims=(32, 16), dropout=0.0),
    "learnable": ModelSpec(k_spatial_centers=(9, 16), k_temporal_centers=(4,),
                           hidden_dims=(32, 16), dropout=0.0,
                           spatial_learnable=True),
    "delta": ModelSpec(k_spatial_centers=(9, 16), k_temporal_centers=(4,),
                       hidden_dims=(32, 16), dropout=0.0, output_dim=3,
                       spatial_learnable=True,
                       use_delta_reparameterization=True),
}
FIT_CFG = dict(k_spatial_centers=[9, 16], k_temporal_centers=[5],
               hidden_dims=[32, 16], dropout=0.1, epochs=8, lr=1e-2,
               batch_size=64, patience=100, warmup_epochs=2,
               scheduler="cosine", grad_clip=10.0, weight_decay=1e-5,
               regression_type="multi-quantile",
               quantile_levels=[0.1, 0.5, 0.9], spatial_learnable=True,
               gradient_damping=True, domain_penalty_weight=0.01,
               sparsity_penalty_type="sparse_group", sparsity_lambda_l1=1e-4,
               sparsity_lambda_group=1e-3, device="cpu")


def _inputs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, 2)).astype(np.float32),
            rng.uniform(size=(n, 1)).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32))


def _synth(n, seed):
    r = np.random.default_rng(seed)
    coords = r.uniform(size=(n, 2)).astype(np.float32)
    t = r.uniform(size=(n, 1)).astype(np.float32)
    y = (np.sin(3 * coords[:, :1]) + 0.5 * t
         + r.normal(0, 0.05, (n, 1))).astype(np.float32)
    return PointSet(coords=coords, t=t, y=y, w=np.ones(n, np.float32),
                    n_real=n)


def _port_model(spec, seed=0):
    model = init_model(torch.Generator().manual_seed(seed), spec,
                       device="cpu")
    with torch.no_grad():     # a delta head starts at zero: move it
        if spec.delta_head:
            model.mlp.delta.copy_(torch.randn(
                model.mlp.delta.shape, generator=torch.Generator()
                .manual_seed(seed + 1)) * 0.1)
    return model


def _gathered_grads(model):
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.detach()
        if name in ttp.SHARDED:
            full = g.new_zeros((g.shape[0] * model.tp.world,)
                               + tuple(g.shape[1:]))
            full[model.rows] = g
            g = model.tp.all_reduce_(full)
        out[name] = g.numpy().copy()
    return out


def _tp_rank(rank, world, jax_tp):
    """Every port-side TP run of this module on one rank."""
    from st_dadk_tpu_torch.parallel.data_parallel import DPGroup
    from st_dadk_tpu_torch.train.optimizer import AdamW
    tp = DPGroup.default("cpu")
    coords, t, y = _inputs()
    out = {"fwd": {}}
    for name, spec in SPECS.items():
        model = _port_model(spec)
        params, consts = to_jax_params(model), model_consts(model)
        fwd = ttp.make_tp_forward(spec, device="cpu")
        out["fwd"][name] = fwd(*ttp.to_tp_params(spec, params, consts, world),
                               coords, t)
    # JAX's own TP layout carried across
    spec = SPECS["learnable"]
    tp_model = from_jax_params(spec, *jax_tp[world], device="cpu",
                               tp=(rank, world))
    with torch.no_grad():
        out["jax_layout"] = tp_model(torch.as_tensor(coords),
                                     torch.as_tensor(t)).numpy()
    # one step, then the pads over several steps at weight decay 0.1
    model = _port_model(spec)
    tpm = ttp.tp_model(spec, *ttp.to_tp_params(
        spec, to_jax_params(model), model_consts(model), world), tp)
    opt = AdamW({"mlp": list(tpm.mlp.parameters()),
                 "basis": list(tpm.basis.parameters())}, 0.0)
    step = ttp.make_tp_train_step(spec, regression="mean",
                                  domain_penalty_weight=0.01,
                                  weight_decay=0.0, device="cpu")
    lrs = {"mlp": 1e-2, "basis": 1e-3}
    xs = [torch.as_tensor(a) for a in (coords, t, y)]
    w = torch.ones(len(coords))
    out["step_loss"] = step(tpm, opt, *xs, w, lrs)
    out["step_grads"] = _gathered_grads(tpm)
    out["step_params"] = tpm.gathered()
    step = ttp.make_tp_train_step(spec, regression="mean",
                                  domain_penalty_weight=0.01,
                                  weight_decay=0.1, device="cpu")
    for i in range(5):
        c, tt, yy = (torch.as_tensor(a) for a in _inputs(64, 10 + i))
        step(tpm, opt, c, tt, yy, w, lrs)
    out["pads"] = {n: p.detach()[~tpm.row_valid].numpy()
                   for n, p in tpm.sharded().items()}
    if world == 2:
        cfg = ExperimentConfig.from_dict(FIT_CFG)
        from st_dadk_tpu_torch.models.st_interp import spec_from_config
        spec_f = spec_from_config(cfg)
        m = _port_model(spec_f, 3)
        state = {}
        r = ttp.fit_tp(cfg, spec_f, to_jax_params(m), model_consts(m),
                       _synth(256, 1), _synth(64, 2), seed=3, device="cpu",
                       state_out=state)
        out["fit"] = {"history": r.history, "params": r.params,
                      "n_epochs_run": r.n_epochs_run}
        out["fit_pads"] = {n: p.detach()[~state["model"].row_valid].numpy()
                           for n, p in state["model"].sharded().items()}
    return out


@pytest.fixture(scope="module")
def jax_tp():
    """JAX's TP layout (numpy) of the learnable spec's JAX params, and JAX
    make_tp_forward's output, at 2 and 4 devices."""
    import jax

    from st_dadk_tpu.models.st_interp import ModelSpec as JSpec
    from st_dadk_tpu.models.st_interp import init_model as jinit
    from st_dadk_tpu.parallel.mesh import make_mesh
    from st_dadk_tpu.parallel.tensor_parallel import (make_tp_forward,
                                                      place_tp, to_tp_params,
                                                      tp_consts_specs,
                                                      tp_param_specs)
    s = SPECS["learnable"]
    jspec = JSpec(k_spatial_centers=s.k_spatial_centers,
                  k_temporal_centers=s.k_temporal_centers,
                  hidden_dims=s.hidden_dims, dropout=0.0,
                  spatial_learnable=True)
    params, consts = jinit(jax.random.PRNGKey(0), jspec)
    coords, t, _ = _inputs()
    layouts, outs = {}, {}
    for n in (2, 4):
        tpp, tpc = to_tp_params(jspec, params, consts, n)
        mesh = make_mesh({"tp": n}, jax.devices()[:n])
        outs[n] = np.asarray(make_tp_forward(jspec, mesh)(
            place_tp(tpp, tp_param_specs(jspec), mesh),
            place_tp(tpc, tp_consts_specs(), mesh), coords, t))
        layouts[n] = (jax.tree_util.tree_map(np.asarray, tpp),
                      jax.tree_util.tree_map(np.asarray, tpc))
    return layouts, outs


@pytest.fixture(scope="module")
def runs(jax_tp):
    from st_dadk_tpu_torch.parallel.launch import run_ranks
    return {n: run_ranks(_tp_rank, n, (n, jax_tp[0])) for n in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_tp_forward_matches_unsharded(runs, world, name):
    spec = SPECS[name]
    coords, t, _ = _inputs()
    with torch.no_grad():
        want = _port_model(spec)(torch.as_tensor(coords),
                                 torch.as_tensor(t)).numpy()
    for r in runs[world]:
        got = r["fwd"][name]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_forward_matches_jax_make_tp_forward(runs, jax_tp, world):
    """JAX's to_tp_params output carried into the port's layout
    (`from_jax_params(..., tp=...)`) against JAX's TP forward."""
    for r in runs[world]:
        np.testing.assert_allclose(r["jax_layout"], jax_tp[1][world],
                                   atol=5e-5)


def test_tp_layout_round_trips_and_equals_jax(jax_tp):
    """The port's to_tp_params of JAX's params is JAX's layout exactly, and
    from_tp_params gives the params back."""
    import jax

    from st_dadk_tpu.models.st_interp import ModelSpec as JSpec
    from st_dadk_tpu.models.st_interp import init_model as jinit
    spec = SPECS["learnable"]
    params, consts = jinit(jax.random.PRNGKey(0), JSpec(
        k_spatial_centers=(9, 16), k_temporal_centers=(4,),
        hidden_dims=(32, 16), dropout=0.0, spatial_learnable=True))
    params = jax.tree_util.tree_map(np.asarray, params)
    consts = {k: np.asarray(v) for k, v in consts.items()}
    for n in (2, 4):
        tpp, tpc = ttp.to_tp_params(spec, params, consts, n)
        jpp, jpc = jax_tp[0][n]
        for a, b in ((ttp._flat(tpp), ttp._flat(jpp)),
                     (ttp._flat(tpc), ttp._flat(jpc))):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        back = ttp._flat(ttp.from_tp_params(spec, tpp))
        for k, v in ttp._flat(params).items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_one_step_matches_unsharded(runs):
    """The TP step against the unsharded step on the same replicated batch:
    mse + 0.01 x domain penalty, AdamW without weight decay."""
    from st_dadk_tpu_torch.ops.losses import mse_loss
    from st_dadk_tpu_torch.train.optimizer import AdamW
    spec = SPECS["learnable"]
    model = _port_model(spec)
    coords, t, y = (torch.as_tensor(a) for a in _inputs())
    loss = mse_loss(model(coords, t), y, torch.ones(len(coords))) \
        + 0.01 * model.domain_penalty()
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    AdamW({"mlp": list(model.mlp.parameters()),
           "basis": list(model.basis.parameters())}, 0.0).step(
        {"mlp": 1e-2, "basis": 1e-3})
    k = spec.k_spatial
    for r in runs[2] + runs[4]:
        assert r["step_loss"] == pytest.approx(float(loss.detach()),
                                               rel=1e-5)
        g = r["step_grads"]
        np.testing.assert_allclose(
            np.concatenate([g["mlp.w0_spatial"][:k], g["mlp.w0_temporal"]]),
            grads["mlp.linear_0.w"], atol=5e-5)
        np.testing.assert_allclose(g["mlp.b0"], grads["mlp.linear_0.b"],
                                   atol=5e-5)
        np.testing.assert_allclose(g["basis.centers"][:k],
                                   grads["basis.centers"], atol=5e-5)
        np.testing.assert_allclose(g["mlp.linear_1.w"],
                                   grads["mlp.linear_1.w"], atol=5e-5)
        assert not g["mlp.w0_spatial"][k:].any()     # pad rows masked
        new = ttp._flat(ttp.from_tp_params(spec, r["step_params"]))
        for n, p in model.named_parameters():
            np.testing.assert_allclose(new[n], p.detach().numpy(), atol=5e-5,
                                       err_msg=n)


@pytest.mark.parametrize("world", [2, 4])
def test_pads_stay_inert_over_steps(runs, world):
    """Five steps at weight decay 0.1: pad rows of w0_spatial stay 0, pad
    centers 0.5 and pad log-bandwidths 0, exactly."""
    for r in runs[world]:
        pads = r["pads"]
        if pads["mlp.w0_spatial"].size == 0:
            continue           # this rank holds no pad row
        assert not pads["mlp.w0_spatial"].any()
        assert (pads["basis.centers"] == 0.5).all()
        assert (pads["basis.log_bandwidths"] == 0.0).all()


def test_fit_tp_tracks_fit(runs):
    """fit_tp over 2 ranks (k 25 -> 26, one pad) against the port's fit,
    dropout on and every penalty of the composite loss: the same generator
    draws the same batches and masks."""
    from st_dadk_tpu_torch.models.st_interp import spec_from_config
    from st_dadk_tpu_torch.train.loop import fit
    cfg = ExperimentConfig.from_dict(FIT_CFG)
    spec = spec_from_config(cfg)
    model = _port_model(spec, 3)
    ref = fit(cfg, spec, model, _synth(256, 1), _synth(64, 2), seed=3)
    for r in runs[2]:
        got = r["fit"]
        assert got["n_epochs_run"] == ref.n_epochs_run == 8
        for k in ("train_loss", "val_loss", "val_rmse"):
            np.testing.assert_allclose(got["history"][k], ref.history[k],
                                       rtol=0.02, atol=5e-4, err_msg=k)
        assert not r["fit_pads"]["mlp.w0_spatial"].any()
        assert (r["fit_pads"]["basis.centers"] == 0.5).all() or \
            r["fit_pads"]["basis.centers"].size == 0


def test_tp_refuses_covariates_and_the_plateau_margin():
    spec = ModelSpec(p=3, k_spatial_centers=(9,), k_temporal_centers=(4,),
                     hidden_dims=(8,), dropout=0.0)
    model = _port_model(spec)
    with pytest.raises(NotImplementedError):
        ttp.to_tp_params(spec, to_jax_params(model), model_consts(model), 4)
    cfg = ExperimentConfig.from_dict(dict(FIT_CFG,
                                          early_stop_min_rel_delta=1e-3))
    with pytest.raises(NotImplementedError, match="early_stop"):
        ttp.fit_tp(cfg, SPECS["learnable"], {}, {}, _synth(8, 0),
                   _synth(8, 1), seed=0, device="cpu")
