"""M fits as lanes of one program: the lane axis of the fused first layer,
`STInterpLanes`, the lane optimizer and `fit_lanes` of st_dadk_tpu_torch
against their single-lane forms and against the JAX package's vmapped fit.

Everything runs on the CPU, where the kernel wrappers take their plain
PyTorch versions; the CUDA kernels' lane axis is checked on the card by
chip_smoke.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.bench_workload import bench_workload as jax_bench
from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu.models import st_interp as jm
from st_dadk_tpu.train import batch_engine as jbe
from st_dadk_tpu.train import experiment as jexp
from st_dadk_tpu.train import loop as jloop
from st_dadk_tpu_torch.bench_workload import bench_workload as torch_bench
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.models import st_interp as tm
from st_dadk_tpu_torch.ops import fused_first_layer as ffl
from st_dadk_tpu_torch.train import batch_engine as tbe
from st_dadk_tpu_torch.train import experiment as texp
from st_dadk_tpu_torch.train import loop as tloop
from st_dadk_tpu_torch.train import optimizer as to
from torch_threads import worker_threads  # noqa: F401

# the bars of the two-dimensional kernels' tests
# (tests/test_torch_fused_first_layer.py): float32 sums in another order
FWD_ATOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
MODEL_ATOL = 5e-5            # tests/test_torch_model.py
# a lane against its single fit, and against the JAX lane: the same float32
# arithmetic in another order (bmm for mm; the JAX fit inside one compiled
# loop), amplified by 3 epochs x 12 AdamW steps. Measured on these toy fits:
# <= 2e-6 relative; 1e-4 leaves 50x margin (tests/test_torch_fit.py).
HIST_RTOL = 1e-4

LANES = 3


# ---------------------------------------------------------------------------
# the lane axis of the three kernels' plain versions
# ---------------------------------------------------------------------------

def _lane_inputs(seed, lanes, n, k, h):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(lanes, n, 2)).astype(np.float32)
    centers = rng.uniform(size=(lanes, k, 2)).astype(np.float32)
    bw = rng.uniform(0.1, 0.8, size=(lanes, k)).astype(np.float32)
    w = (rng.normal(size=(lanes, k, h)) * 0.1).astype(np.float32)
    g = rng.normal(size=(lanes, n, h)).astype(np.float32)
    return coords, centers, bw, w, g


def _port_lanes_value_and_grads(coords, centers, bw, w, g, basis):
    c = torch.as_tensor(centers).requires_grad_(True)
    b = torch.as_tensor(bw).requires_grad_(True)
    ww = torch.as_tensor(w).requires_grad_(True)
    out = ffl.fused_spatial_first_layer(torch.as_tensor(coords), c, b, ww,
                                        basis)
    grads = torch.autograd.grad(torch.sum(out * torch.as_tensor(g)),
                                (c, b, ww))
    return out.detach().numpy(), [x.numpy() for x in grads]


def test_lane_first_layer_matches_jax_kernel_vmapped():
    """Against the JAX custom-VJP kernel vmapped over 3 lanes, run in Pallas
    interpret mode as the JAX package's own tests run it on the CPU."""
    try:
        from jax.experimental.pallas import tpu as pltpu
    except ImportError:
        pytest.skip("pallas tpu backend unavailable")
    from st_dadk_tpu.ops.pallas_fused import fused_spatial_first_layer

    args = _lane_inputs(3, LANES, 120, 37, 24)
    fn = jax.vmap(lambda c, ce, b, w: fused_spatial_first_layer(
        c, ce, b, w, "wendland"))
    coords, centers, bw, w, g = (jnp.asarray(a) for a in args)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(coords, centers, bw, w))
        want_g = jax.grad(lambda ce, b, ww: jnp.sum(fn(coords, ce, b, ww) * g),
                          argnums=(0, 1, 2))(centers, bw, w)
    got, got_g = _port_lanes_value_and_grads(*args, "wendland")
    assert got.shape == (LANES, 120, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    for a, b, name in zip(got_g, want_g, ("dcenters", "dbandwidths", "dW")):
        np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("basis", ["wendland", "gaussian", "triangular"])
def test_lane_wrappers_equal_the_two_dimensional_call_a_lane(basis):
    """Each lane of a 3-D call is the 2-D call on that lane's operands: a
    lane's result depends on no other lane. On the CPU the two take the same
    plain version, so the bar is the batched matmul's summation order."""
    coords, centers, bw, w, g = (torch.as_tensor(a) for a in
                                 _lane_inputs(5, LANES, 77, 37, 19))
    bid = ffl.BASIS_IDS[basis]
    inv_bw = 1.0 / (bw * ffl.CALIBRATION_FACTORS[basis])
    out = ffl.fused_first_layer_fwd(coords, centers, inv_bw, w, bid)
    dw = ffl.fused_first_layer_bwd_w(coords, centers, inv_bw, g, bid)
    dc, dib = ffl.fused_first_layer_bwd_centers(coords, centers, inv_bw, w, g,
                                                bid)
    assert out.shape == (LANES, 77, 19) and dw.shape == (LANES, 37, 19)
    assert dc.shape == (LANES, 37, 2) and dib.shape == (LANES, 37)
    for m in range(LANES):
        ops = (coords[m], centers[m], inv_bw[m])
        np.testing.assert_allclose(
            out[m], ffl.fused_first_layer_fwd(*ops, w[m], bid), atol=1e-5)
        np.testing.assert_allclose(
            dw[m], ffl.fused_first_layer_bwd_w(*ops, g[m], bid), rtol=1e-5,
            atol=1e-5)
        dc1, dib1 = ffl.fused_first_layer_bwd_centers(*ops, w[m], g[m], bid)
        np.testing.assert_allclose(dc[m], dc1, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(dib[m], dib1, rtol=1e-4, atol=1e-4)


def test_lane_launch_refuses_what_the_grid_cannot_hold():
    """Lanes x slabs past the end of a grid dimension raise, not wrap; and
    the spatial gradient, whose kernel has no lane axis, is refused."""
    assert ffl._lanes("x", (4,), 8) == 4 and ffl._lanes("x", ()) == 1
    with pytest.raises(ValueError, match="exceed"):
        ffl._lanes("x", (8192,), 8)
    coords, centers, bw, w, g = (torch.as_tensor(a) for a in
                                 _lane_inputs(5, 2, 16, 5, 4))
    coords.requires_grad_(True)
    out = ffl.fused_spatial_first_layer(coords, centers, bw, w, "wendland")
    with pytest.raises(NotImplementedError, match="lane"):
        out.sum().backward()


# ---------------------------------------------------------------------------
# STInterpLanes
# ---------------------------------------------------------------------------

_MODEL = dict(k_spatial_centers=[4, 9], k_temporal_centers=[4, 6],
              hidden_dims=[32, 16], dropout=0.1,
              quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95])


def _jax_lane_models(learnable, delta):
    d = dict(_MODEL, spatial_learnable=learnable,
             regression_type="multi-quantile" if delta else "mean",
             use_delta_reparameterization=delta)
    spec_j = jm.spec_from_config(JaxConfig.from_dict(d), use_pallas=False)
    spec_t = tm.spec_from_config(ExperimentConfig.from_dict(d))
    rng = np.random.default_rng(11)
    lanes = []
    for m in range(LANES):
        centers = rng.uniform(size=(spec_j.k_spatial, 2)).astype(np.float32)
        bws = rng.uniform(0.2, 0.6, size=(spec_j.k_spatial,)).astype(np.float32)
        params, consts = jm.init_model(jax.random.PRNGKey(m), spec_j,
                                       jnp.asarray(centers), jnp.asarray(bws))
        if delta:    # a zero delta head would make every lane's output 0
            params["mlp"]["delta"] = jnp.asarray(rng.normal(
                size=params["mlp"]["delta"].shape).astype(np.float32))
        lanes.append((params, consts))
    return spec_j, spec_t, lanes


@pytest.mark.parametrize("learnable,delta", [(False, False), (True, True),
                                             (True, False)])
def test_lanes_model_matches_single_models_and_jax(learnable, delta):
    spec_j, spec_t, lanes = _jax_lane_models(learnable, delta)
    singles = [tm.from_jax_params(spec_t, p, c, device="cpu")
               for p, c in lanes]
    model = tm.stack_lane_models(singles)
    assert model.lanes == LANES
    rng = np.random.default_rng(1)
    coords = rng.uniform(size=(LANES, 50, 2)).astype(np.float32)
    t = rng.uniform(size=(LANES, 50, 1)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.as_tensor(coords), torch.as_tensor(t)).numpy()
    assert got.shape == (LANES, 50, spec_t.output_dim)
    for m, (single, (params, consts)) in enumerate(zip(singles, lanes)):
        with torch.no_grad():
            one = single(torch.as_tensor(coords[m]),
                         torch.as_tensor(t[m])).numpy()
        np.testing.assert_allclose(got[m], one, rtol=0, atol=MODEL_ATOL)
        want = np.asarray(jm.forward(spec_j, params, consts, None,
                                     jnp.asarray(coords[m]),
                                     jnp.asarray(t[m]), train=False))
        np.testing.assert_allclose(got[m], want, rtol=0, atol=MODEL_ATOL)
    assert np.abs(got[0] - got[1]).max() > 1e-3      # lanes do differ


def test_lane_params_round_trip_in_jax_layout():
    """lane_params gives lane i back in the JAX layout: the
    weights cross lane by lane through from_jax_params."""
    _, spec_t, lanes = _jax_lane_models(True, True)
    singles = [tm.from_jax_params(spec_t, p, c, device="cpu")
               for p, c in lanes]
    model = tm.stack_lane_models(singles)
    assert tuple(model.basis.centers.shape) == (LANES, 13, 2)
    assert tuple(model.mlp.linear_0.w.shape) == (LANES, 13 + 10, 32)
    assert tuple(model.mlp.delta.shape) == (LANES, 5, 17)
    for m, single in enumerate(singles):
        back = tm.from_jax_params(spec_t, tm.lane_params(model, m),
                                  tm.model_consts(single), device="cpu")
        for (na, a), (nb, b) in zip(single.named_parameters(),
                                    back.named_parameters()):
            assert na == nb and torch.equal(a, b), na
        for nm in ("spatial_centers_init", "spatial_bandwidths_init",
                   "temporal_centers"):
            assert torch.equal(getattr(single, nm), getattr(back, nm)), nm


def test_lanes_model_penalties_and_dropout():
    _, spec_t, lanes = _jax_lane_models(True, True)
    singles = [tm.from_jax_params(spec_t, p, c, device="cpu")
               for p, c in lanes]
    with torch.no_grad():
        for s in singles:       # move the centers, a few out of the domain
            s.basis.centers.add_(0.3 * torch.randn(
                s.basis.centers.shape,
                generator=torch.Generator().manual_seed(3)))
    model = tm.stack_lane_models(singles)
    got = {"domain": model.domain_penalty(),
           "movement": model.movement_penalty(),
           "sparsity": model.sparsity_penalty("sparse_group", 1e-3,
                                              1e-2)["total_penalty"]}
    for m, s in enumerate(singles):
        want = {"domain": s.domain_penalty(), "movement": s.movement_penalty(),
                "sparsity": s.sparsity_penalty("sparse_group", 1e-3,
                                               1e-2)["total_penalty"]}
        for key in got:
            assert got[key].shape == (LANES,)
            assert float(got[key][m].detach()) == pytest.approx(
                float(want[key].detach()), rel=1e-5), key
    coords, t = torch.rand(LANES, 64, 2), torch.rand(LANES, 64, 1)
    a = model(coords, t, train=True,
              generator=torch.Generator().manual_seed(0))
    b = model(coords, t, train=True,
              generator=torch.Generator().manual_seed(0))
    c = model(coords, t, train=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        model(coords, t, train=True)


def _phi_route_lanes(route):
    """LANES JAX models of one phi-route spec (params drawn by the JAX
    init) and the port's spec: with `padded_lane`, real widths 4, 13 and 16
    padded to 16, each lane's junk rows 0 and its own column mask."""
    rng = np.random.default_rng(5)
    p = route.get("p", 0)
    k_real = ((4,), (4, 9), (16,)) if route.get("padded_lane") else ((16,),) * 3
    spec_t = tm.ModelSpec(k_spatial_centers=(16,), k_temporal_centers=(5,),
                          hidden_dims=(8, 4), spatial_learnable=True, **route)
    spec_pad_j = jm.ModelSpec(p=p, k_spatial_centers=(16,),
                              k_temporal_centers=(5,), hidden_dims=(8, 4),
                              spatial_learnable=True, use_pallas=False)
    lanes = []
    for m, kr in enumerate(k_real):
        spec_real = dataclasses.replace(spec_pad_j, k_spatial_centers=kr)
        k = sum(kr)
        params, consts = jm.init_model(
            jax.random.PRNGKey(m), spec_real,
            jnp.asarray(rng.uniform(size=(k, 2)).astype(np.float32)),
            jnp.asarray(rng.uniform(0.2, 0.6, size=(k,)).astype(np.float32)))
        np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
        params, consts = np_tree(params), np_tree(consts)
        if route.get("padded_lane"):
            params, consts = jm.pad_lane_model(spec_real, 16, params, consts)
        lanes.append((params, consts, k))
    return spec_pad_j, spec_t, lanes


@pytest.mark.parametrize("route", [dict(padded_lane=True, phi_route=True),
                                   dict(phi_route=True),
                                   dict(p=2, phi_route=True)],
                         ids=["ragged", "phi", "covariates"])
def test_lanes_model_refuses_the_phi_route(route):
    """Lanes build on the materialised-phi route, and what they refuse
    there is a mask that does not fit the spec. On that route
    `STInterpLanes` equals the single (padded) `STInterp`s and the JAX
    (padded) forward
    (tests/test_ragged_k.py:99), lane by lane, at MODEL_ATOL; junk rows get
    exactly zero gradients and the penalties never see them. What it still
    refuses: a padded-lane spec without masks, and masks on any other."""
    spec_j, spec_t, lanes = _phi_route_lanes(route)
    singles = [tm.from_jax_params(spec_t, p, c, device="cpu")
               for p, c, _ in lanes]
    model = tm.stack_lane_models(singles)
    rng = np.random.default_rng(2)
    coords = rng.uniform(size=(LANES, 31, 2)).astype(np.float32)
    t = rng.uniform(size=(LANES, 31, 1)).astype(np.float32)
    X = rng.normal(size=(LANES, 31, spec_t.p)).astype(np.float32)
    Xt = torch.as_tensor(X) if spec_t.p else None
    out = model(torch.as_tensor(coords), torch.as_tensor(t), X=Xt)
    for m, (single, (params, consts, k)) in enumerate(zip(singles, lanes)):
        with torch.no_grad():
            one = single(torch.as_tensor(coords[m]), torch.as_tensor(t[m]),
                         X=None if Xt is None else Xt[m]).numpy()
        np.testing.assert_allclose(out[m].detach().numpy(), one, rtol=0,
                                   atol=MODEL_ATOL)
        want = np.asarray(jm.forward(
            spec_j, params, consts, jnp.asarray(X[m]) if spec_t.p else None,
            jnp.asarray(coords[m]), jnp.asarray(t[m]), train=False))
        np.testing.assert_allclose(out[m].detach().numpy(), want, rtol=0,
                                   atol=MODEL_ATOL)
    pen = (model.domain_penalty() + model.movement_penalty()
           + model.sparsity_penalty("sparse_group", 1e-3, 1e-2)["total_penalty"])
    (out.sum() + pen.sum()).backward()
    w0 = model.mlp.linear_0.w
    for m, (_, _, k) in enumerate(lanes):
        rows = slice(spec_t.p + k, spec_t.p + 16)
        assert torch.all(w0.grad[m, rows] == 0)
        assert torch.all(model.basis.centers.grad[m, k:] == 0)
        assert torch.all(model.basis.log_bandwidths.grad[m, k:] == 0)
        assert torch.any(w0.grad[m, spec_t.p:spec_t.p + k] != 0)
        single = singles[m]
        for name in ("domain_penalty", "movement_penalty"):
            assert float(getattr(model, name)()[m].detach()) == pytest.approx(
                float(getattr(single, name)().detach()), rel=1e-6)
        assert float(model.sparsity_penalty("sparse_group", 1e-3, 1e-2)[
            "total_penalty"][m]) == pytest.approx(float(
                single.sparsity_penalty("sparse_group", 1e-3, 1e-2)[
                    "total_penalty"]), rel=1e-6)
    if spec_t.p:
        with pytest.raises(ValueError, match="covariates"):
            model(torch.as_tensor(coords), torch.as_tensor(t))
    centers = np.zeros((2, 16, 2), np.float32)
    bws, mask = np.ones((2, 16), np.float32), np.ones((2, 16), np.float32)
    with pytest.raises(ValueError, match="spatial_k_mask"):
        tm.STInterpLanes(spec_t, centers, bws,
                         None if spec_t.padded_lane else mask)
    if spec_t.padded_lane:
        with pytest.raises(ValueError, match="spatial_k_mask shape"):
            tm.STInterpLanes(spec_t, centers, bws, mask[:, :5])
        # stripping a padded lane gives the real-shape model's forward
        params, consts, k = lanes[0]
        real_spec = dataclasses.replace(spec_j, k_spatial_centers=(k,))
        sp, sc = jm.strip_lane_padding(real_spec, 16, params, consts)
        want = np.asarray(jm.forward(real_spec, sp, sc, None,
                                     jnp.asarray(coords[0]),
                                     jnp.asarray(t[0]), train=False))
        np.testing.assert_allclose(out[0].detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the lane optimizer
# ---------------------------------------------------------------------------

def _lane_tensors(rng, shapes):
    return [rng.normal(size=(LANES,) + s).astype(np.float32) for s in shapes]


def test_lane_adamw_ema_and_clip_match_single_lane_forms():
    """Three steps of AdamWLanes / ema_update_lanes / clip_by_global_norm_lanes_
    against the single-lane forms a lane; lane 1 is masked in step 2 and must
    not change there, moments, step count and EMA included."""
    rng = np.random.default_rng(0)
    shapes = [(7, 3), (3,), (6, 2)]
    init = _lane_tensors(rng, shapes)
    grads = [_lane_tensors(rng, shapes) for _ in range(3)]
    grads[1] = [g * 40 for g in grads[1]]            # so that clipping acts
    lrs = rng.uniform(1e-3, 2e-2, size=(3, LANES, 2)).astype(np.float32)
    executes = np.ones((3, LANES), bool)
    executes[1, 1] = False
    decay = np.asarray([0.99, 0.95, 0.9], np.float32)

    lp = [torch.nn.Parameter(torch.as_tensor(x.copy())) for x in init]
    opt = to.AdamWLanes({"mlp": lp[:2], "basis": lp[2:]}, 5e-4)
    ema = [p.detach().clone() for p in lp]
    frozen = None
    for s in range(3):
        for p, g in zip(lp, grads[s]):
            p.grad = torch.as_tensor(g.copy())
        to.clip_by_global_norm_lanes_([p.grad for p in lp[:2]], 1.0)
        if s == 1:
            frozen = [x[1].clone() for x in
                      [p.detach() for p in lp] + ema
                      + [opt.m[id(p)] for p in lp] + [opt.v[id(p)] for p in lp]]
        opt.step(torch.as_tensor(lrs[s]), torch.as_tensor(executes[s]))
        to.ema_update_lanes(ema, lp, torch.as_tensor(decay),
                            torch.as_tensor(1.0 - decay),
                            torch.as_tensor(executes[s]))
        if s == 1:
            after = [x[1] for x in
                     [p.detach() for p in lp] + ema
                     + [opt.m[id(p)] for p in lp] + [opt.v[id(p)] for p in lp]]
            for a, b in zip(frozen, after):
                assert torch.equal(a, b)
    assert opt.step_count.tolist() == [3, 2, 3]

    for m in range(LANES):
        sp = [torch.nn.Parameter(torch.as_tensor(x[m].copy())) for x in init]
        sopt = to.AdamW({"mlp": sp[:2], "basis": sp[2:]}, 5e-4)
        sema = [p.detach().clone() for p in sp]
        for s in range(3):
            if not executes[s, m]:
                continue
            for p, g in zip(sp, grads[s]):
                p.grad = torch.as_tensor(g[m].copy())
            to.clip_by_global_norm_([p.grad for p in sp[:2]], 1.0)
            sopt.step({"mlp": float(lrs[s, m, 0]),
                       "basis": float(lrs[s, m, 1])})
            to.ema_update(sema, sp, float(decay[m]))
        # the same formula with per-lane tensors for the scalars: float32
        # rounding of the bias corrections and of 1 - decay
        for a, b in zip(lp, sp):
            np.testing.assert_allclose(a.detach()[m], b.detach(), rtol=2e-6,
                                       atol=1e-7)
        for a, b in zip(ema, sema):
            np.testing.assert_allclose(a[m], b, rtol=2e-6, atol=1e-7)


def test_lane_adamw_keeps_a_masked_lane_with_a_non_finite_gradient():
    p = torch.nn.Parameter(torch.ones(2, 4))
    opt = to.AdamWLanes({"mlp": [p]}, 0.0)
    p.grad = torch.tensor([[1.0] * 4, [float("nan")] * 4])
    opt.step(torch.full((2, 1), 0.1), torch.tensor([True, False]))
    assert torch.equal(p.detach()[1], torch.ones(4))
    assert bool(torch.isfinite(opt.m[id(p)]).all())
    assert not torch.equal(p.detach()[0], torch.ones(4))


# ---------------------------------------------------------------------------
# fit_lanes
# ---------------------------------------------------------------------------

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
def lanes_setup(toy_csv):
    """JAX and port setups of experiments 1..3 (seeds differ: other masks,
    other weights) with the JAX-initialised params carried across."""
    d = dict(OVERRIDES, data_file=str(toy_csv))
    cfg_j = JaxConfig.from_dict(jax_bench(**d))
    cfg_t = ExperimentConfig.from_dict(torch_bench(**d))
    setups_j = [jexp.ExperimentSetup(cfg_j, i) for i in range(1, LANES + 1)]
    setups_t = []
    for i, sj in enumerate(setups_j, start=1):
        st = texp.ExperimentSetup(cfg_t, i, "cpu", defer_model=True)
        st.model = tm.from_jax_params(st.spec, sj.params, sj.consts,
                                      device="cpu")
        setups_t.append(st)
    return cfg_j, cfg_t, setups_j, setups_t


def _fit_port_lanes(cfg_t, setups_t):
    stacked = tbe._stack_lane_host(cfg_t, setups_t, torch.device("cpu"))
    model = tm.stack_lane_models([s.model for s in setups_t])
    return tloop.fit_lanes(cfg_t, setups_t[0].spec, model, stacked["data"],
                           stacked["lr_steps"], stacked["lr_recorded"],
                           [s.experiment_seed for s in setups_t])


@pytest.fixture(scope="module")
def port_lane_fits(lanes_setup):
    _, cfg_t, _, setups_t = lanes_setup
    return _fit_port_lanes(cfg_t, setups_t)


def test_fit_lanes_matches_single_fits(lanes_setup, port_lane_fits):
    _, cfg_t, _, setups_t = lanes_setup
    for st, lane in zip(setups_t, port_lane_fits):
        single = tloop.fit(cfg_t, st.spec, st.model, st.train_ps, st.valid_ps,
                           seed=st.experiment_seed)
        assert lane.n_epochs_run == single.n_epochs_run == 3
        assert lane.n_steps == single.n_steps
        for key in ("train_loss", "val_loss", "val_rmse"):
            np.testing.assert_allclose(lane.history[key], single.history[key],
                                       rtol=HIST_RTOL, err_msg=key)
        np.testing.assert_array_equal(lane.history["lr"],
                                      single.history["lr"])
        assert lane.best_val == pytest.approx(single.best_val, rel=HIST_RTOL)
        np.testing.assert_allclose(lane.center_shift, single.center_shift,
                                   atol=1e-6)
        np.testing.assert_allclose(lane.params["basis"]["centers"],
                                   single.params["basis"]["centers"],
                                   atol=1e-5)
    a, b = port_lane_fits[0].history, port_lane_fits[1].history
    assert abs(a["val_loss"][-1] - b["val_loss"][-1]) > 1e-4   # lanes differ


def test_fit_lanes_matches_the_jax_vmapped_fit(lanes_setup, port_lane_fits):
    """Against jitted_fit_chunk(spec, vmapped=True, lr_per_lane=True) on
    carries built with init_carry from the same params, as the JAX lane
    engine runs it."""
    cfg_j, _, setups_j, _ = lanes_setup
    stacked = jbe._stack_lane_host(cfg_j, setups_j)
    spec = jloop.LoopSpec.from_config(
        cfg_j, setups_j[0].spec, stacked["batch_size"], stacked["B_shared"],
        stacked["val_chunk"], stacked["n_val_chunks"])
    if any(int(d.n_batches) != stacked["B_shared"] for d in stacked["datas"]):
        spec = dataclasses.replace(spec, uniform_lanes=False)
    stack = lambda trees: jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *trees)
    carry_b = stack([jloop.init_carry(s.params,
                                      jax.random.PRNGKey(s.experiment_seed))
                     for s in setups_j])
    consts_b = stack([s.consts for s in setups_j])
    data_b = jax.tree_util.tree_map(jnp.asarray, stacked["data_b"])
    E = cfg_j.epochs
    fit_chunk = jloop.jitted_fit_chunk(spec, vmapped=True, lr_per_lane=True)
    carry_b, hist = fit_chunk(carry_b, consts_b, data_b,
                              jnp.arange(E, dtype=jnp.int32),
                              jnp.asarray(stacked["lr_steps"]),
                              jnp.ones((E,), bool))
    serving, _ = jloop.select_serving_device(carry_b)
    for m, lane in enumerate(port_lane_fits):
        for key in ("train_loss", "val_loss", "val_rmse"):
            np.testing.assert_allclose(lane.history[key],
                                       np.asarray(hist[key])[m],
                                       rtol=HIST_RTOL, err_msg=f"{key} {m}")
        assert lane.best_val == pytest.approx(
            float(np.asarray(carry_b["best_val"])[m]), rel=HIST_RTOL)
        np.testing.assert_allclose(
            lane.params["basis"]["centers"],
            np.asarray(serving["basis"]["centers"])[m], atol=1e-5)
        np.testing.assert_allclose(
            lane.params["mlp"]["linear_0"]["w"],
            np.asarray(serving["mlp"]["linear_0"]["w"])[m], atol=1e-4)


def test_shuffled_lane_sees_its_whole_capacity():
    """A lane with fewer real batches than the widest lane sees all of its
    own points in its executed batches, every epoch
    (tests/test_batch_engine.py::test_epoch_indices_cover_lane_capacity)."""
    bs, B, n_batches = 32, 5, (3, 5)
    idx = (torch.arange(B * bs) % (B * bs)).repeat(2, 1)
    gens = [torch.Generator().manual_seed(s) for s in (7, 8)]
    seen = []
    for _ in range(4):
        tloop.shuffle_lane_indices_(idx, n_batches, bs, gens)
        executed = idx[0].reshape(B, bs)[:3].ravel()
        assert set(executed.tolist()) == set(range(3 * bs))
        assert set(idx[1].tolist()) == set(range(B * bs))
        seen.append(idx[0].clone())
    assert not torch.equal(seen[0], seen[1])      # a fresh order an epoch


def _two_lane_batch(toy_csv, **kw):
    d = dict(OVERRIDES, data_file=str(toy_csv), **kw)
    cfg = ExperimentConfig.from_dict(torch_bench(**d))
    setups = [texp.ExperimentSetup(cfg, i, "cpu") for i in (1, 2)]
    return cfg, setups


def test_lane_with_fewer_batches_trains_on_its_own_schedule(toy_csv):
    """obs_ratio 0.3 beside 0.9: the lanes share a batch size and the wider
    lane's step count; the narrow lane executes only its own batches, takes
    its own LR table and EMA decay, and finishes finite."""
    lo = ExperimentConfig.from_dict(torch_bench(**dict(
        OVERRIDES, data_file=str(toy_csv), obs_ratio=0.3, shuffle="auto")))
    hi = lo.replace(obs_ratio=0.9)
    setups = [texp.ExperimentSetup(lo, 1, "cpu"),
              texp.ExperimentSetup(hi, 1, "cpu")]
    stacked = tbe._stack_lane_host(lo, setups, torch.device("cpu"))
    data = stacked["data"]
    assert data.n_batches[0] < data.n_batches[1] == data.B_shared
    assert data.ema_decay[0] < data.ema_decay[1]
    assert stacked["lr_steps"].shape == (2, 3, data.B_shared, 2)
    model = tm.stack_lane_models([s.model for s in setups])
    fits = tloop.fit_lanes(lo, setups[0].spec, model, data,
                           stacked["lr_steps"], stacked["lr_recorded"],
                           [s.experiment_seed for s in setups])
    assert [f.n_steps for f in fits] == [3 * b for b in data.n_batches]
    for f in fits:
        assert np.all(np.isfinite(f.history["train_loss"]))
        assert np.all(np.isfinite(f.history["val_loss"]))


def test_a_stopped_lane_keeps_its_state_while_the_others_train_on(toy_csv):
    """Lane 1's validation targets are NaN, so it never improves and stops
    at epoch `patience`; lane 0 trains on. Lane 1's result is what a batch
    cut at that epoch gives it, bitwise, and its history ends there."""
    cfg, setups = _two_lane_batch(toy_csv, epochs=6, patience=2)
    stacked = tbe._stack_lane_host(cfg, setups, torch.device("cpu"))
    va_y = stacked["data"].va_y.clone()
    va_y[1] = float("nan")
    data = stacked["data"]._replace(va_y=va_y)
    seeds = [s.experiment_seed for s in setups]

    def run(cfg_run, epochs):
        model = tm.stack_lane_models([s.model for s in setups])
        return tloop.fit_lanes(cfg_run, setups[0].spec, model, data,
                               stacked["lr_steps"][:, :epochs],
                               [r[:epochs] for r in stacked["lr_recorded"]],
                               seeds)

    long = run(cfg, 6)
    short = run(cfg.replace(epochs=2), 2)
    assert long[1].stopped_early and long[1].n_epochs_run == 2
    assert len(long[1].history["train_loss"]) == 2
    assert long[1].n_steps == short[1].n_steps == 2 * data.n_batches[1]
    assert not long[0].stopped_early and long[0].n_epochs_run == 6
    assert long[0].n_steps == 6 * data.n_batches[0]
    assert np.all(np.isfinite(long[0].history["val_loss"]))
    flat = lambda tree: texp._flatten_params(tree)
    for (name, a), b in zip(flat(long[1].params).items(),
                            flat(short[1].params).values()):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(long[0].history["train_loss"][:2],
                                  short[0].history["train_loss"])


def test_fit_lanes_refuses_mismatched_lanes(lanes_setup):
    _, cfg_t, _, setups_t = lanes_setup
    stacked = tbe._stack_lane_host(cfg_t, setups_t, torch.device("cpu"))
    model = tm.stack_lane_models([s.model for s in setups_t[:2]])
    with pytest.raises(ValueError, match="lanes"):
        tloop.fit_lanes(cfg_t, setups_t[0].spec, model, stacked["data"],
                        stacked["lr_steps"], stacked["lr_recorded"],
                        [1, 2, 3])


def test_predict_lanes_matches_predict(lanes_setup):
    _, _, _, setups_t = lanes_setup
    model = tm.stack_lane_models([s.model for s in setups_t])
    rng = np.random.default_rng(2)
    coords = rng.uniform(size=(70, 2)).astype(np.float32)
    t = rng.uniform(size=(70,)).astype(np.float32)
    got = tloop.predict_lanes(model, coords, t, chunk=32)
    assert got.shape == (LANES, 70, 5)
    for m, s in enumerate(setups_t):
        np.testing.assert_allclose(got[m],
                                   tloop.predict(s.model, coords, t, 32),
                                   rtol=0, atol=MODEL_ATOL)
