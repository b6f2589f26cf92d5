"""The port's forecasting path against the JAX package's: the window
datasets (`dataio/windows.py`, bitwise), the forecaster's forward with
carried weights (dropout off, atol 1e-5), one AdamW step on a fixed batch
(the grads at rtol 1e-4 / atol 1e-7, the updated params at atol 1e-6),
`fit_forecaster`'s semantics and its win over persistence on an AR field
(tests/test_forecaster.py:45), and the legacy basis (phi at the basis bar,
atol 2e-6, tests/test_pallas_basis.py:46). On the CPU the phi kernel
wrapper takes its plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.dataio import windows as jwin
from st_dadk_tpu.models import forecaster as jfc
from st_dadk_tpu.models import legacy_basis as jleg
from st_dadk_tpu.train.optimizer import adamw_init, adamw_update
from st_dadk_tpu_torch.dataio import windows as twin
from st_dadk_tpu_torch.models import forecaster as tfc
from st_dadk_tpu_torch.models import legacy_basis as tleg
from st_dadk_tpu_torch.train.optimizer import AdamW

FWD_ATOL = 1e-5
PHI_ATOL = 2e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
STEP_ATOL = 1e-6

SMALL = dict(L=6, H=4, k_spatial_centers=(9, 16), k_temporal_centers=(4, 6),
             hidden_dims=(24, 12))


def _ar_field(T=80, S=30, phi=0.9, noise=0.1, seed=0):
    """tests/test_forecaster.py's strongly autocorrelated field."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(S, 2)).astype(np.float32)
    base = np.sin(4 * coords[:, 0]) + np.cos(3 * coords[:, 1])
    z = np.empty((T, S), np.float32)
    z[0] = base + rng.normal(0, 0.3, S)
    for t in range(1, T):
        z[t] = base + phi * (z[t - 1] - base) + rng.normal(0, noise, S)
    return z, coords


def _same_dataset(a, b):
    for f in dataclasses.fields(jwin.WindowDataset):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("kw", [
    {}, {"stride": 3}, {"use_coords_cov": True},
    {"use_time_cov": True}, {"use_time_cov": True,
                             "time_encoding": "sinusoidal",
                             "use_coords_cov": True},
    {"t0_min": 9, "t0_max": 30}], ids=str)
def test_window_dataset_bitwise_jax(kw):
    z, coords = _ar_field(T=40, S=12)
    obs = np.array([0, 3, 4, 7, 11])
    got = twin.build_window_dataset(z, coords, obs, 5, 3, **kw)
    want = jwin.build_window_dataset(z, coords, obs, 5, 3, **kw)
    _same_dataset(got, want)
    assert len(got) == len(want) and got.p_covariates == want.p_covariates


def test_window_split_and_test_context_bitwise_jax():
    z, coords = _ar_field(T=30, S=10)
    obs = np.arange(0, 10, 2)
    for ratio in (0.2, 0.5, 0.95):
        for g, w in zip(twin.train_valid_window_split(z, coords, obs, 6, 3,
                                                      val_ratio=ratio),
                        jwin.train_valid_window_split(z, coords, obs, 6, 3,
                                                      val_ratio=ratio)):
            _same_dataset(g, w)
    got = twin.prepare_test_context(z, coords, obs, 6)
    want = jwin.prepare_test_context(z, coords, obs, 6)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="too short"):
        twin.train_valid_window_split(z[:9], coords, obs, 6, 3)
    with pytest.raises(ValueError, match="t0_min"):
        twin.build_window_dataset(z, coords, obs, 6, 3, t0_min=2)


def test_rows_from_windows_bitwise_jax():
    z, coords = _ar_field()
    ds = twin.build_window_dataset(z, coords, np.arange(30), L=5, H=3)
    got = tfc.rows_from_windows(ds, 80)
    want = jfc.rows_from_windows(ds, 80)
    for g, w, name in zip(got, want, jfc.ForecastData._fields):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _pair(spec_kw, seed=0):
    """A JAX-initialised forecaster and the port's model holding it."""
    jspec = jfc.ForecastSpec(**spec_kw)
    tspec = tfc.ForecastSpec(**spec_kw)
    params, consts = jfc.init_forecaster(jax.random.PRNGKey(seed), jspec)
    params = jax.tree_util.tree_map(np.asarray, params)
    model = tfc.forecaster_from_jax(tspec, params, consts, device="cpu")
    return jspec, params, consts, model


def _batch(spec, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, spec.L)).astype(np.float32),
            rng.uniform(size=(n, 2)).astype(np.float32),
            rng.uniform(size=(n, 1)).astype(np.float32),
            rng.normal(size=(n, spec.H)).astype(np.float32))


def test_spec_defaults_and_carried_weights_equal_jax():
    assert dataclasses.asdict(tfc.ForecastSpec()) == dataclasses.asdict(
        jfc.ForecastSpec())
    assert tfc.ForecastSpec().input_dim == jfc.ForecastSpec().input_dim
    jspec, params, consts, model = _pair({})
    back = tfc.forecaster_params(model)
    assert back.keys() == params.keys()
    for layer in params:
        for leaf in params[layer]:
            np.testing.assert_array_equal(back[layer][leaf],
                                          params[layer][leaf])
    # the model's own fixed grids are JAX's consts
    fresh = tfc.Forecaster(tfc.ForecastSpec())
    for name in ("spatial_centers", "spatial_bandwidths", "temporal_centers",
                 "temporal_bandwidths"):
        np.testing.assert_array_equal(getattr(fresh, name).numpy(),
                                      np.asarray(consts[name]))


@pytest.mark.parametrize("spec_kw", [{}, SMALL], ids=["defaults", "small"])
def test_forward_matches_jax_with_carried_weights(spec_kw):
    jspec, params, consts, model = _pair(spec_kw, seed=3)
    yh, c, t0, _ = _batch(jspec, 257, seed=4)
    want = np.asarray(jfc.forward_forecaster(jspec, params, consts, yh, c,
                                             t0))
    got = tfc.predict_forecaster(model, yh, c, t0, chunk=100)
    assert got.shape == want.shape == (257, jspec.H)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    # train mode with dropout 0 is the eval forward
    model0 = tfc.forecaster_from_jax(dataclasses.replace(
        tfc.ForecastSpec(**spec_kw), dropout=0.0), params, consts,
        device="cpu")
    with torch.no_grad():
        out = model0(*(torch.as_tensor(a) for a in (yh, c, t0)), train=True)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=FWD_ATOL)


def test_dropout_draws_from_the_generator():
    _, _, _, model = _pair(SMALL)
    yh, c, t0, _ = (torch.as_tensor(a) for a in _batch(
        tfc.ForecastSpec(**SMALL), 64, seed=5))
    with pytest.raises(ValueError, match="generator"):
        model(yh, c, t0, train=True)
    a = model(yh, c, t0, train=True,
              generator=torch.Generator().manual_seed(1))
    b = model(yh, c, t0, train=True,
              generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, model(yh, c, t0))


def test_one_adamw_step_matches_jax():
    """One AdamW step at a flat lr on a fixed batch, dropout off: JAX's
    jax.grad + adamw_update against the port's autograd + AdamW."""
    spec_kw = dict(SMALL, dropout=0.0)
    jspec, params, consts, model = _pair(spec_kw, seed=6)
    yh, c, t0, yf = _batch(jspec, 128, seed=7)
    lr, wd = 3e-3, 1e-5

    def loss_fn(p):
        pred = jfc.forward_forecaster(jspec, p, consts, yh, c, t0)
        return jnp.mean((pred - yf) ** 2)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    grads = jax.grad(loss_fn)(jp)
    lr_tree = jax.tree_util.tree_map(lambda _: jnp.asarray(lr), jp)
    new_p, _ = adamw_update(jp, grads, adamw_init(jp), lr_tree, wd)

    loss = torch.mean((model(*(torch.as_tensor(a) for a in (yh, c, t0)))
                       - torch.as_tensor(yf)) ** 2)
    loss.backward()
    named = dict(model.named_parameters())
    for layer in params:
        for leaf in params[layer]:
            np.testing.assert_allclose(
                named[f"{layer}.{leaf}"].grad.numpy(),
                np.asarray(grads[layer][leaf]), rtol=GRAD_RTOL,
                atol=GRAD_ATOL, err_msg=f"grad {layer}.{leaf}")
    opt = AdamW({"mlp": list(model.parameters())}, wd)
    opt.step({"mlp": lr})
    got = tfc.forecaster_params(model)
    for layer in params:
        for leaf in params[layer]:
            np.testing.assert_allclose(got[layer][leaf],
                                       np.asarray(new_p[layer][leaf]),
                                       rtol=0, atol=STEP_ATOL,
                                       err_msg=f"{layer}.{leaf}")


def test_fit_beats_persistence_on_ar_field():
    """tests/test_forecaster.py:45 on the port: a noisy AR field, where
    copying the last value copies the noise."""
    z, coords = _ar_field(T=80, S=30, phi=0.8, noise=0.35)
    spec = tfc.ForecastSpec(L=8, H=3, k_spatial_centers=(9,),
                            k_temporal_centers=(4,), hidden_dims=(64, 32),
                            dropout=0.0)
    tr, va = twin.train_valid_window_split(z, coords, np.arange(30), spec.L,
                                           spec.H, val_ratio=0.2)
    tr_rows, va_rows = (tfc.rows_from_windows(d, 80) for d in (tr, va))
    model = tfc.init_forecaster(torch.Generator().manual_seed(0), spec,
                                device="cpu")
    best, hist = tfc.fit_forecaster(model, tr_rows, va_rows, epochs=250,
                                    batch_size=256, lr=3e-3, patience=60,
                                    seed=0)
    assert np.isfinite(hist["best_val"])
    preds = tfc.predict_forecaster(model, va_rows.y_hist, va_rows.coords,
                                   va_rows.t0)
    mse = float(np.mean((preds - va_rows.y_fut) ** 2))
    persistence = np.repeat(va_rows.y_hist[:, -1:], spec.H, axis=1)
    mse_p = float(np.mean((persistence - va_rows.y_fut) ** 2))
    assert mse < mse_p, (mse, mse_p)
    # the model holds the best params: its validation MSE is best_val
    assert mse == pytest.approx(hist["best_val"], rel=1e-5)
    for layer, leaves in best.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(
                dict(model.named_parameters())[f"{layer}.{leaf}"]
                .detach().numpy(), v)


def test_fit_history_early_stop_and_tiling(monkeypatch):
    """JAX's semantics: val_mse has `epochs` entries, NaN after the stop;
    n_epochs_run counts the run; the rows are tiled to ceil(n/bs)*bs and
    each epoch draws one permutation of them."""
    spec = tfc.ForecastSpec(**dict(SMALL, hidden_dims=(8,), dropout=0.0))
    rng = np.random.default_rng(2)
    n = 10

    def rows(m):
        return tfc.ForecastData(
            rng.normal(size=(m, spec.L)).astype(np.float32),
            rng.uniform(size=(m, 2)).astype(np.float32),
            rng.uniform(size=(m, 1)).astype(np.float32),
            rng.normal(size=(m, spec.H)).astype(np.float32))

    tr, va = rows(n), rows(6)
    caps = []
    randperm = torch.randperm

    def spy(cap, **kw):
        caps.append(cap)
        return randperm(cap, **kw)

    monkeypatch.setattr(torch, "randperm", spy)
    model = tfc.init_forecaster(torch.Generator().manual_seed(1), spec,
                                device="cpu")
    # lr 0: the validation MSE never improves after the first epoch
    _, hist = tfc.fit_forecaster(model, tr, va, epochs=12, batch_size=4,
                                 lr=0.0, patience=3, seed=0)
    assert hist["n_epochs_run"] == 4 and caps == [12] * 4
    v = hist["val_mse"]
    assert v.shape == (12,) and np.all(np.isfinite(v[:4]))
    assert np.all(np.isnan(v[4:])) and hist["best_val"] == v[0]


def test_forecaster_phi_takes_no_backward_kernel(monkeypatch):
    """phi's centers and coords are constants: a training step's backward
    reaches no basis backward wrapper (on the card: no backward launch),
    where a phi with learnable centers reaches d centers."""
    from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
    calls = []
    for name in ("spatial_basis_bwd_points", "spatial_basis_bwd_centers"):
        fn = getattr(sbk, name)
        monkeypatch.setattr(sbk, name, lambda *a, _fn=fn, _n=name, **k:
                            calls.append(_n) or _fn(*a, **k))
    _, _, _, model = _pair(SMALL)
    yh, c, t0, yf = (torch.as_tensor(a) for a in _batch(
        tfc.ForecastSpec(**SMALL), 32, seed=8))
    torch.mean((model(yh, c, t0) - yf) ** 2).backward()
    assert calls == [] and model.linear_0.w.grad is not None
    centers = model.spatial_centers.clone().requires_grad_(True)
    sbk.spatial_basis_embed_kernel(c, centers, model.spatial_bandwidths
                                   ).sum().backward()
    assert calls == ["spatial_basis_bwd_centers"]


def test_legacy_basis_matches_jax():
    tc, tb = tleg.legacy_centers_and_bandwidths()
    jc, jb = jleg.legacy_centers_and_bandwidths()
    assert tc.shape == (227, 2) and tb.shape == (227,)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tb, jb)
    coords = np.random.default_rng(0).uniform(size=(300, 2)).astype(
        np.float32)
    got = tleg.embed(torch.as_tensor(coords)).numpy()
    want = np.asarray(jleg.embed(jnp.asarray(coords)))
    assert got.shape == want.shape == (300, 227)
    np.testing.assert_allclose(got, want, rtol=0, atol=PHI_ATOL)
    assert got.min() >= 0.0 and got.max() <= 1.0 + 1e-6
    r = torch.linspace(0, 1.5, 31)
    np.testing.assert_allclose(tleg.wendland_phi(r).numpy(),
                               np.asarray(jleg.wendland_phi(jnp.asarray(
                                   r.numpy()))), rtol=0, atol=PHI_ATOL)
