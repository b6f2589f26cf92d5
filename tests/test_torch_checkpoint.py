"""Checkpoint and resume of the port's single fit (st_dadk_tpu_torch.train.
loop.fit with `checkpoint_path`): the npz cases of tests/test_checkpoint.py
(an interrupted and resumed fit is the uninterrupted one bit for bit, a
session budget that is not a chunk multiple, a budget of 0, a resume after
the end), the file's layout against the JAX package's, and a directory
that JAX's Orbax wrote, which the port refuses (its own directories:
tests/test_torch_checkpoint_dir.py)."""
import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.dataio.arrays import PointSet
from st_dadk_tpu_torch.models.st_interp import (init_model, spec_from_config,
                                                to_jax_params)
from st_dadk_tpu_torch.train import checkpoint as tck
from st_dadk_tpu_torch.train.loop import fit, load_fit_checkpoint
from torch_threads import worker_threads  # noqa: F401


def _synthetic(n=256, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    t = rng.uniform(size=(n, 1)).astype(np.float32)
    y = (np.sin(3 * coords[:, :1]) + 0.5 * t).astype(np.float32)
    return PointSet(coords=coords, t=t, y=y, w=np.ones(n, np.float32),
                    n_real=n)


def _cfg(epochs, **kw):
    """tests/test_checkpoint.py's fit, with the learnable basis and
    shuffled batches and dropout on, so that every part of the state
    (both AdamW groups, the generator) must come back."""
    return ExperimentConfig.from_dict({**dict(
        k_spatial_centers=[9], k_temporal_centers=[4], hidden_dims=[16, 8],
        dropout=0.1, epochs=epochs, lr=5e-3, batch_size=64, patience=100,
        warmup_epochs=2, scheduler="cosine", grad_clip=10.0,
        regression_type="mean", spatial_learnable=True,
        basis_unfreeze_epoch=1), **kw})


def _fit(cfg, **kw):
    spec = spec_from_config(cfg)
    model = init_model(torch.Generator().manual_seed(3), spec, device="cpu")
    return fit(cfg, spec, model, _synthetic(256, 0), _synthetic(64, 1),
               seed=3, **kw), model


def _same_params(a, b):
    flat = lambda t, p="": ({f"{p}{k}": v for k, v in t.items()}
                            if not any(isinstance(v, dict) for v in t.values())
                            else {kk: vv for k, v in t.items()
                                  for kk, vv in flat(v, f"{p}{k}.").items()})
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=k)


@pytest.mark.parametrize("shuffle", ["auto", "perm"])
def test_resume_bitwise_equals_uninterrupted(tmp_path, shuffle):
    cfg = _cfg(12, shuffle=shuffle)
    full, _ = _fit(cfg, epochs_chunk=4)
    ckpt = tmp_path / "fit.ckpt.npz"
    partial, _ = _fit(cfg, epochs_chunk=4, checkpoint_path=ckpt,
                      session_epochs=8)
    assert ckpt.exists() and partial.n_epochs_run == 8
    resumed, _ = _fit(cfg, epochs_chunk=4, checkpoint_path=ckpt, resume=True)
    assert resumed.n_epochs_run == full.n_epochs_run == 12
    for k in ("train_loss", "val_loss", "val_rmse", "lr"):
        np.testing.assert_array_equal(resumed.history[k], full.history[k])
    np.testing.assert_array_equal(resumed.center_shift, full.center_shift)
    _same_params(resumed.params, full.params)
    _same_params(resumed.final_ema, full.final_ema)
    assert resumed.n_steps == full.n_steps and \
        resumed.best_val == full.best_val


def test_session_budget_not_a_chunk_multiple(tmp_path):
    cfg = _cfg(12)
    full, _ = _fit(cfg, epochs_chunk=4)
    ckpt = tmp_path / "fit.ckpt.npz"
    partial, _ = _fit(cfg, epochs_chunk=8, checkpoint_path=ckpt,
                      session_epochs=5)
    assert partial.n_epochs_run == 5
    _, epochs_done, _ = load_fit_checkpoint(ckpt)
    assert epochs_done == 5
    resumed, _ = _fit(cfg, epochs_chunk=8, checkpoint_path=ckpt, resume=True)
    assert resumed.n_epochs_run == 12
    np.testing.assert_array_equal(resumed.history["train_loss"],
                                  full.history["train_loss"])
    _same_params(resumed.params, full.params)


def test_session_budget_zero_returns_initial_state():
    cfg = _cfg(8)
    spec = spec_from_config(cfg)
    model = init_model(torch.Generator().manual_seed(0), spec, device="cpu")
    params_in = to_jax_params(model)
    r = fit(cfg, spec, model, _synthetic(128, 0), _synthetic(32, 1), seed=0,
            epochs_chunk=4, session_epochs=0)
    assert r.n_epochs_run == 0 and len(r.history["train_loss"]) == 0
    _same_params(r.params, params_in)


def test_resume_skips_when_finished_and_stopped(tmp_path):
    cfg = _cfg(8)
    ckpt = tmp_path / "c.npz"
    r1, _ = _fit(cfg, epochs_chunk=4, checkpoint_path=ckpt)
    r2, _ = _fit(cfg, epochs_chunk=4, checkpoint_path=ckpt, resume=True)
    assert r2.n_epochs_run == r1.n_epochs_run == 8
    np.testing.assert_array_equal(r2.history["val_loss"],
                                  r1.history["val_loss"])
    _same_params(r2.params, r1.params)
    # an early stop is saved where it happens, and a resume trains no more
    stop = _cfg(12, patience=1, early_stop_min_rel_delta=0.5)
    ck2 = tmp_path / "stop.npz"
    s1, _ = _fit(stop, epochs_chunk=50, checkpoint_path=ck2)
    assert s1.stopped_early and s1.n_epochs_run < 12
    s2, _ = _fit(stop, epochs_chunk=50, checkpoint_path=ck2, resume=True)
    assert s2.stopped_early and s2.n_epochs_run == s1.n_epochs_run
    assert s2.n_steps == s1.n_steps
    _same_params(s2.params, s1.params)


def test_checkpoint_layout_is_the_jax_packages(tmp_path):
    """The npz names of JAX's save_fit_checkpoint (the carry flattened to
    dotted names, `__epochs_done`, `__hist.*`), with the generator's state
    in place of the PRNG key."""
    import jax
    from st_dadk_tpu.models.st_interp import init_model as jax_init
    from st_dadk_tpu.models.st_interp import spec_from_config as jax_spec
    from st_dadk_tpu.train.loop import init_carry, save_fit_checkpoint

    cfg = _cfg(2)
    ckpt = tmp_path / "t.npz"
    _fit(cfg, epochs_chunk=1, checkpoint_path=ckpt)
    from st_dadk_tpu.config import ExperimentConfig as JaxConfig
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    params, _ = jax_init(jax.random.PRNGKey(3), jax_spec(jcfg))
    jck = tmp_path / "j.npz"
    save_fit_checkpoint(jck, init_carry(params, jax.random.PRNGKey(3)), 2,
                        [{k: np.zeros(2) for k in
                          ("train_loss", "val_loss", "val_rmse")}])
    port = set(np.load(ckpt).files)
    jax_names = set(np.load(jck).files)
    assert jax_names - {"__key_data"} <= port
    assert port - jax_names == {"__generator_state", "__hist.center_shift",
                                "__hist.centers_epochs", "__hist.centers"}


def test_orbax_directory_path_is_refused(tmp_path):
    """A directory path is the port's own checkpoint directory now; what it
    refuses, with the reason, is a directory that JAX's Orbax wrote, as a
    load and as a resume (before any epoch runs)."""
    import jax

    from st_dadk_tpu.config import ExperimentConfig as JaxConfig
    from st_dadk_tpu.models.st_interp import init_model as jax_init
    from st_dadk_tpu.models.st_interp import spec_from_config as jax_spec
    from st_dadk_tpu.train.checkpoint import save_checkpoint as jax_save
    from st_dadk_tpu.train.loop import init_carry

    cfg = _cfg(2)
    params, _ = jax_init(jax.random.PRNGKey(3),
                         jax_spec(JaxConfig.from_dict(cfg.to_dict())))
    orbax = tmp_path / "orbax_ckpt"
    jax_save(orbax, init_carry(params, jax.random.PRNGKey(3)), 2, [])
    assert tck.is_orbax_path(orbax) and tck.checkpoint_exists(orbax)
    with pytest.raises(ValueError, match="Orbax"):
        tck.load_checkpoint(orbax)
    with pytest.raises(ValueError, match="Orbax"):
        _fit(cfg, checkpoint_path=orbax, resume=True)
    own = tmp_path / "ck.ckpt"
    assert tck.is_orbax_path(own) and not tck.checkpoint_exists(own)
    _fit(cfg, checkpoint_path=own)
    assert (own / "state" / ".metadata").is_file()
    assert tck.load_checkpoint(own)[1] == 2
    assert not tck.is_orbax_path(tmp_path / "ck.npz")
    assert not tck.checkpoint_exists(tmp_path / "ck.npz")
