"""The bf16 trunk of st_dadk_tpu_torch (`train_dtype: bf16`) against the JAX
package's (st_dadk_tpu/models/st_interp.py `trunk` / `_trunk_from_h1`):

- the forward on each route with JAX-initialised params carried across:
  the fused route against JAX's `forward_train_fused` (`use_fused_training:
  true`, Pallas in interpret mode, as tests/test_pallas_fused.py runs it),
  the materialised-phi route against JAX's jnp `forward`; in eval mode and
  in train mode with JAX's dropout masks handed across. Bar: max |d| within
  1e-2 of max |y|, and no farther from JAX's bf16 than JAX's bf16 is from
  JAX's float32;
- dropout divides by bf16(1 - p), the head returns float32, params stay
  float32, and the backward kernels' plain versions receive float32
  cotangents;
- a bf16 fit tracks the float32 fit at JAX's bar
  (tests/test_train_loop.py:372-395);
- `auto` by model size and by lane width, never over an explicit value
  (tests/test_auto_dtype.py).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu.models import st_interp as jm
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.dataio.arrays import PointSet
from st_dadk_tpu_torch.models import st_interp as tm
from st_dadk_tpu_torch.ops import fused_first_layer as ffl
from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
from st_dadk_tpu_torch.train import batch_engine as tbe
from st_dadk_tpu_torch.train import loop as tloop
from torch_threads import worker_threads  # noqa: F401

MODEL = dict(k_spatial_centers=[25, 81], k_temporal_centers=[4, 6],
             hidden_dims=[32, 16], dropout=0.1, spatial_learnable=True,
             regression_type="multi-quantile",
             quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
             use_delta_reparameterization=True)
REL_BAR = 1e-2


def _points(seed, n=96):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, 2)).astype(np.float32),
            rng.uniform(size=(n, 1)).astype(np.float32))


def _jax_spec(route, dtype):
    fused = route == "fused"
    return jm.spec_from_config(JaxConfig.from_dict(dict(
        MODEL, train_dtype=dtype, use_fused_training=fused)),
        use_pallas=fused)


def _jax_forward(route, dtype, params, consts, coords, t, train, rng):
    spec = _jax_spec(route, dtype)
    assert spec.compute_dtype == dtype
    if route == "fused":
        from jax.experimental.pallas import tpu as pltpu
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(jm.forward(spec, params, consts, None, coords,
                                         t, train=train, rng=rng))
    return np.asarray(jm.forward(spec, params, consts, None, coords, t,
                                 train=train, rng=rng))


@pytest.mark.parametrize("route", ["fused", "phi"])
@pytest.mark.parametrize("train", [False, True])
def test_bf16_forward_matches_jax(route, train, monkeypatch):
    params, consts = jm.init_model(jax.random.PRNGKey(0),
                                   _jax_spec(route, "f32"))
    coords, t = _points(1)
    rng = jax.random.PRNGKey(3)
    want = {dt: _jax_forward(route, dt, params, consts, jnp.asarray(coords),
                             jnp.asarray(t), train, rng)
            for dt in ("f32", "bf16")}
    spec = tm.spec_from_config(ExperimentConfig.from_dict(
        dict(MODEL, train_dtype="bf16")))
    assert spec.compute_dtype == "bf16"
    model = tm.from_jax_params(spec, params, consts, device="cpu")
    if train:
        masks = [torch.as_tensor(np.asarray(m)) for m in
                 jm._dropout_masks(_jax_spec(route, "bf16"), rng, 96)]
        monkeypatch.setattr(tm.STInterp, "_dropout_masks",
                            lambda self, n, g, d: masks)
    with torch.no_grad():
        got = model(torch.as_tensor(coords), torch.as_tensor(t), train=train,
                    generator=torch.Generator(), fused=route == "fused")
    assert got.dtype == torch.float32 and got.shape == want["bf16"].shape
    d_port = float(np.abs(got.numpy() - want["bf16"]).max())
    d_jax = float(np.abs(want["bf16"] - want["f32"]).max())
    scale = float(np.abs(want["bf16"]).max())
    assert d_port <= REL_BAR * scale, (d_port, scale)
    assert d_port <= d_jax, (d_port, d_jax)


def test_lanes_bf16_forward_is_each_lanes_single_forward():
    """STInterpLanes in bf16 on both routes: lane i within bf16 rounding of
    its single model's bf16 forward, far nearer than the float32 one."""
    spec = tm.spec_from_config(ExperimentConfig.from_dict(
        dict(MODEL, train_dtype="bf16")))
    singles = [tm.init_model(torch.Generator().manual_seed(s), spec,
                             device="cpu") for s in (0, 1)]
    coords, t = _points(2)
    c = torch.as_tensor(coords).expand(2, -1, -1).contiguous()
    tt = torch.as_tensor(t).expand(2, -1, -1).contiguous()
    lanes = tm.stack_lane_models(singles)
    for phi in (False, True):
        sp = dataclasses.replace(spec, phi_route=phi)
        lanes.spec = sp
        with torch.no_grad():
            got = lanes(c, tt)
        assert got.dtype == torch.float32
        for i, m in enumerate(singles):
            with torch.no_grad():
                m.spec = sp
                one = m(c[i], tt[i], fused=not phi)
                m.spec = dataclasses.replace(sp, compute_dtype="f32")
                f32 = m(c[i], tt[i], fused=not phi)
            gap, ref = (float((got[i] - one).abs().max()),
                        float((one - f32).abs().max()))
            assert gap <= max(ref, 1e-6), (phi, i, gap, ref)


def test_dropout_divides_by_bf16_of_keep():
    spec = tm.ModelSpec(k_spatial_centers=(9,), k_temporal_centers=(4,),
                        hidden_dims=(16,), dropout=0.1, layernorm=False,
                        compute_dtype="bf16")
    div = tm._keep_divisor(spec)
    assert div.dtype == torch.bfloat16 and float(div) == 0.8984375
    model = tm.init_model(torch.Generator().manual_seed(0), spec,
                          device="cpu")
    h1 = torch.randn(64, 16, generator=torch.Generator().manual_seed(1))
    keep = [torch.ones(64, 16, dtype=torch.bool)]
    model._dropout_masks = lambda n, g, d: keep
    with torch.no_grad():
        train = model.trunk_from_h1(h1, True, torch.Generator())
        ev = model.trunk_from_h1(h1, False, None)
    assert train.dtype == torch.bfloat16
    assert torch.equal(train, ev / div)
    # a float32 0.9 would round another way in a share of the entries
    assert not torch.equal(train, ev / 0.9)


def test_bf16_params_stay_f32_and_backward_kernels_get_f32(monkeypatch):
    """One training step on each route: the cotangents that reach the
    backward kernels' plain versions are float32 (the gradients of the
    casts after them), every gradient and parameter stays float32."""
    seen = []

    def spy(mod, name, g_pos):
        orig = getattr(mod, name)

        def wrapped(*a, **kw):
            seen.append((name, a[g_pos].dtype))
            return orig(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    spy(ffl, "plain_bwd_w", 3)
    spy(ffl, "plain_bwd_centers", 4)
    spy(sbk, "plain_bwd_centers", 3)
    spec = tm.spec_from_config(ExperimentConfig.from_dict(
        dict(MODEL, train_dtype="bf16")))
    coords, t = _points(4)
    for fused in (True, False):
        model = tm.init_model(torch.Generator().manual_seed(0), spec,
                              device="cpu")
        y = model(torch.as_tensor(coords), torch.as_tensor(t), train=True,
                  generator=torch.Generator().manual_seed(2), fused=fused)
        assert y.dtype == torch.float32
        y.square().mean().backward()
        for name, p in model.named_parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
            assert torch.isfinite(p.grad).all(), name
    names = {n for n, _ in seen}
    assert names == {"plain_bwd_w", "plain_bwd_centers"}, names
    assert len(seen) == 3 and all(d == torch.float32 for _, d in seen), seen


def _synthetic(n=512, seed=0):
    """tests/test_train_loop.py's synthetic field."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    t = rng.uniform(size=(n, 1)).astype(np.float32)
    y = (np.sin(3 * coords[:, :1]) + np.cos(2 * coords[:, 1:2]) + 0.5 * t
         ).astype(np.float32)
    return PointSet(coords=coords, t=t, y=y, w=np.ones(n, np.float32),
                    n_real=n)


def test_bf16_fit_tracks_f32():
    """JAX's TestTrainDtypeBf16 on the port (its config, data and bars):
    the bf16 fit trains, its params and predictions stay float32, and its
    validation RMSE is within 0.15 of the float32 fit's."""
    train_ps, valid_ps = _synthetic(512, 0), _synthetic(128, 1)
    rmse = {}
    for dt in ("f32", "bf16"):
        cfg = ExperimentConfig.from_dict(dict(
            k_spatial_centers=[16], k_temporal_centers=[5],
            hidden_dims=[32, 16], dropout=0.0, epochs=30, lr=1e-2,
            batch_size=64, patience=100, warmup_epochs=2, scheduler="cosine",
            grad_clip=10.0, weight_decay=1e-5, regression_type="mean",
            train_dtype=dt))
        spec = tm.spec_from_config(cfg)
        assert spec.compute_dtype == dt
        model = tm.init_model(torch.Generator().manual_seed(42), spec,
                              device="cpu")
        res = tloop.fit(cfg, spec, model, train_ps, valid_ps, seed=42)
        hist = res.history
        assert np.all(np.isfinite(hist["train_loss"])), dt
        assert hist["train_loss"][-1] < hist["train_loss"][0] * 0.8, dt
        for leaf in jax.tree_util.tree_leaves(res.params):
            assert leaf.dtype == np.float32, dt
        serving = tm.from_jax_params(spec, res.params,
                                     tm.model_consts(model), device="cpu")
        preds = tloop.predict(serving, valid_ps.coords, valid_ps.t,
                              chunk=256)
        assert preds.dtype == np.float32, dt
        rmse[dt] = float(np.sqrt(np.mean((preds - valid_ps.y) ** 2)))
    assert rmse["bf16"] < 0.5
    assert abs(rmse["bf16"] - rmse["f32"]) < 0.15


# -- 'auto' (tests/test_auto_dtype.py) --------------------------------------

def _setups(n, dtype="f32"):
    return [SimpleNamespace(spec=tm.ModelSpec(compute_dtype=dtype))
            for _ in range(n)]


def test_auto_default_resolves_f32_and_explicit_values_pass():
    cfg = ExperimentConfig()
    assert cfg.train_dtype == "auto"
    assert tm.spec_from_config(cfg).compute_dtype == "f32"
    for dt in ("f32", "bf16"):
        cfg = ExperimentConfig.from_dict({"train_dtype": dt})
        assert tm.spec_from_config(cfg).compute_dtype == dt
    with pytest.raises(ValueError, match="train_dtype"):
        tm.spec_from_config(ExperimentConfig.from_dict(
            {"train_dtype": "float16"}))


def test_auto_thresholds_keep_todays_paths_float32():
    """No measured threshold flips a path that runs today at its
    defaults: the bench's sum of 640 and a 10-lane batch stay float32."""
    size, lanes = tm.AUTO_BF16_HIDDEN_SUM, tbe.AUTO_BF16_LANES
    assert size is None or size > 640
    assert lanes is None or lanes >= 10
    bench = ExperimentConfig.from_dict({"hidden_dims": [256, 256, 128]})
    assert tm.spec_from_config(bench).compute_dtype == "f32"
    setups = _setups(10)
    tbe._apply_auto_train_dtype(bench, setups, 10)
    assert all(s.spec.compute_dtype == "f32" for s in setups)


def test_auto_flips_by_size(monkeypatch):
    # the H100's crossover (models/st_interp.py): 2560
    assert tm.AUTO_BF16_HIDDEN_SUM == 2560
    for dims, want in (([256, 256, 128], "f32"), ([512, 512, 256], "f32"),
                       ([1024, 1024, 512], "bf16")):
        cfg = ExperimentConfig.from_dict({"hidden_dims": dims})
        assert tm.spec_from_config(cfg).compute_dtype == want, dims
    monkeypatch.setattr(tm, "AUTO_BF16_HIDDEN_SUM", 1280)
    for dims, want in (([256, 256, 128], "f32"), ([512, 512, 256], "bf16"),
                       ([1024, 1024, 512], "bf16")):
        cfg = ExperimentConfig.from_dict({"hidden_dims": dims})
        assert tm.spec_from_config(cfg).compute_dtype == want, dims
    pinned = ExperimentConfig.from_dict({"hidden_dims": [1024, 1024, 512],
                                         "train_dtype": "f32"})
    assert tm.spec_from_config(pinned).compute_dtype == "f32"


def test_auto_flips_wide_batches_only(monkeypatch):
    assert tbe._padded_lanes_per_device(16, 1, None) == 16
    assert tbe._padded_lanes_per_device(9, 8, None) == 2
    assert tbe._padded_lanes_per_device(4, 1, 16) == 16
    assert tbe._padded_lanes_per_device(4, 8, 12) == 1
    monkeypatch.setattr(tbe, "AUTO_BF16_LANES", 16)
    cfg = ExperimentConfig()
    narrow, wide = _setups(3), _setups(3)
    tbe._apply_auto_train_dtype(cfg, narrow, 16)
    tbe._apply_auto_train_dtype(cfg, wide, 17)
    assert all(s.spec.compute_dtype == "f32" for s in narrow)
    assert all(s.spec.compute_dtype == "bf16" for s in wide)
    pinned = _setups(2)
    tbe._apply_auto_train_dtype(
        ExperimentConfig.from_dict({"train_dtype": "f32"}), pinned, 64)
    assert all(s.spec.compute_dtype == "f32" for s in pinned)
    kept = _setups(2, dtype="bf16")
    tbe._apply_auto_train_dtype(
        ExperimentConfig.from_dict({"train_dtype": "bf16"}), kept, 1)
    assert all(s.spec.compute_dtype == "bf16" for s in kept)


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    d = tmp_path_factory.mktemp("bf16")
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (d / "toy.csv").write_text("\n".join(lines))
    return d / "toy.csv"


def test_wide_batch_trains_bf16_through_the_engine(toy_csv, tmp_path,
                                                   monkeypatch):
    """A batch past a (patched) lane threshold trains, validates and
    predicts in bf16 through `run_job_batch` and writes finite scores;
    tests/test_auto_dtype.py's engine case."""
    monkeypatch.setattr(tbe, "AUTO_BF16_LANES", 1)
    seen = []
    orig = tloop.fit_lanes

    def spy(cfg, spec, model, *a, **kw):
        seen.append((spec.compute_dtype, model.spec.compute_dtype))
        return orig(cfg, spec, model, *a, **kw)
    monkeypatch.setattr(tbe, "fit_lanes", spy)
    cfg = ExperimentConfig.from_dict(dict(
        data_file=str(toy_csv), k_spatial_centers=[9], k_temporal_centers=[4],
        hidden_dims=[16, 8], dropout=0.1, epochs=3, batch_size=64,
        obs_ratio=0.5, regression_type="mean", save_plots=False,
        save_artifacts=False))
    jobs = [(cfg, e, tmp_path / str(e)) for e in (1, 2)]
    res = tbe.run_job_batch(jobs, device="cpu")
    assert seen == [("bf16", "bf16")]
    assert all(np.isfinite(r["test_rmse"]) for r in res)
