"""The epoch shuffle of st_dadk_tpu_torch.train.loop against the JAX
package's (st_dadk_tpu/train/loop.py:381-461): the keyed multiply-xorshift
bijection bit for bit for the same multipliers, `epoch_batch_indices` in its
four modes, the lanes' hash shuffle, and the first shuffled paired fit:
JAX-initialised params, dropout 0, JAX's per-epoch multipliers handed to
the port, three epochs of `shuffle: auto`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.bench_workload import bench_workload as jax_bench
from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu.train import experiment as jexp
from st_dadk_tpu.train import loop as jloop
from st_dadk_tpu_torch.bench_workload import bench_workload as torch_bench
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.models import st_interp as tm
from st_dadk_tpu_torch.train import batch_engine as tbe
from st_dadk_tpu_torch.train import experiment as texp
from st_dadk_tpu_torch.train import loop as tloop
from torch_threads import worker_threads  # noqa: F401

# The paired fits run the same float32 arithmetic in another order on the
# same batches, as tests/test_torch_fit.py's fits under `shuffle: none`
# (measured there <= 5e-7 relative); the shuffle adds no arithmetic, so the
# same 1e-4 bar holds, ~1000x below the epoch-to-epoch change of the losses.
HIST_RTOL = 1e-4

OVERRIDES = dict(
    k_spatial_centers=[4, 9], k_temporal_centers=[5], hidden_dims=[32, 16],
    dropout=0.0, epochs=3, warmup_epochs=1, basis_unfreeze_epoch=1,
    basis_lr_rampup_epochs=2, patience=50, obs_ratio=0.5,
    spatial_init_method="uniform")


def _jax_multipliers(key, cap):
    """The four values JAX's hash_permutation draws from `key` for `cap`."""
    return np.array(jax.random.randint(key, (4,), 0, tloop.hash_width(cap),
                                         dtype=jnp.int32))


@pytest.mark.parametrize("cap", [1, 2, 512, 1000, 8000, 8192])
def test_hash_permutation_any_bitwise_jax(cap):
    for s in range(4):
        key = jax.random.PRNGKey(s)
        want = np.asarray(jloop.hash_permutation_any(key, cap))
        r = torch.as_tensor(_jax_multipliers(key, cap), dtype=torch.int64)
        got = tloop.hash_permutation_any(r, cap)
        assert got.dtype == torch.int64 and got.shape == (cap,)
        np.testing.assert_array_equal(got.numpy(), want)
        assert sorted(got.tolist()) == list(range(cap))
    # a lane axis: each row its own multipliers, the row alone bit for bit
    rs = torch.stack([torch.as_tensor(_jax_multipliers(
        jax.random.PRNGKey(s), cap), dtype=torch.int64) for s in range(3)])
    rows = tloop.hash_permutation_any(rs, cap)
    for s in range(3):
        assert torch.equal(rows[s], tloop.hash_permutation_any(rs[s], cap))


def test_hash_multipliers_range_and_stream():
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    for cap in (8, 1000):
        r = tloop.hash_multipliers(cap, g1, "cpu")
        assert r.shape == (4,) and r.dtype == torch.int64
        assert int(r.min()) >= 0 and int(r.max()) < tloop.hash_width(cap)
        assert torch.equal(r, torch.randint(0, tloop.hash_width(cap), (4,),
                                            generator=g2))
    assert tloop.hash_width(1000) == 1024 and tloop.hash_width(512) == 512


@pytest.mark.parametrize("mode", ["none", "perm", "hash", "auto"])
def test_epoch_batch_indices_modes(monkeypatch, mode):
    """'none' is the identity order; 'perm' torch.randperm from the fit's
    generator; 'hash' and 'auto' JAX's uniform-lane indices for the same
    multipliers (JAX epoch_batch_indices, uniform=True)."""
    cap, bs, B = 96, 16, 6
    key = jax.random.PRNGKey(9)
    r = torch.as_tensor(_jax_multipliers(key, cap), dtype=torch.int64)
    monkeypatch.setattr(tloop, "hash_multipliers", lambda c, g, d: r)
    got = tloop.epoch_batch_indices(cap, bs, B, mode,
                                    torch.Generator().manual_seed(2), "cpu")
    assert got.shape == (B, bs)
    if mode == "perm":
        want = torch.randperm(cap, generator=torch.Generator().manual_seed(2))
        assert torch.equal(got.ravel(), want)
    else:
        want = np.asarray(jloop.epoch_batch_indices(
            key, cap, bs, B, jnp.asarray(B), uniform=True, shuffle=mode))
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="shuffle"):
        tloop.epoch_batch_indices(cap, bs, B, "sort", None, "cpu")


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    """The toy field of tests/test_torch_fit.py."""
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


def test_shuffled_paired_fit_matches_jax(toy_csv, monkeypatch):
    """Three epochs of `shuffle: auto` from JAX's params: the port, handed
    the multipliers JAX draws each epoch (fold_in(key, epoch), split, then
    randint), trains on JAX's batches and its losses follow JAX's."""
    d = dict(OVERRIDES, data_file=str(toy_csv), shuffle="auto")
    cfg_j = JaxConfig.from_dict(jax_bench(**d))
    cfg_t = ExperimentConfig.from_dict(torch_bench(**d))
    sj = jexp.ExperimentSetup(cfg_j, 1)
    st = texp.ExperimentSetup(cfg_t, 1, "cpu", defer_model=True)
    st.model = tm.from_jax_params(st.spec, sj.params, sj.consts,
                                  device="cpu")
    res_j = jloop.fit(cfg_j, sj.spec, sj.params, sj.consts, sj.train_ps,
                      sj.valid_ps, seed=sj.experiment_seed)

    root = jax.random.PRNGKey(sj.experiment_seed)
    epochs = iter(range(cfg_t.epochs))

    def jax_epoch_multipliers(cap, generator, device):
        perm_key, _ = jax.random.split(jax.random.fold_in(root, next(epochs)))
        return torch.as_tensor(_jax_multipliers(perm_key, cap),
                               dtype=torch.int64, device=device)

    monkeypatch.setattr(tloop, "hash_multipliers", jax_epoch_multipliers)
    res_t = tloop.fit(cfg_t, st.spec, st.model, st.train_ps, st.valid_ps,
                      seed=st.experiment_seed)
    assert res_t.n_epochs_run == res_j.n_epochs_run == 3
    for key in ("train_loss", "val_loss", "val_rmse"):
        np.testing.assert_allclose(res_t.history[key], res_j.history[key],
                                   rtol=HIST_RTOL, err_msg=key)
    # the shuffle did change the batches: the identity order trains apart
    monkeypatch.undo()
    st.model = tm.from_jax_params(st.spec, sj.params, sj.consts,
                                  device="cpu")
    plain = tloop.fit(cfg_t.replace(extra=dict(cfg_t.extra, shuffle="none")),
                      st.spec, st.model, st.train_ps, st.valid_ps,
                      seed=st.experiment_seed)
    assert not np.allclose(plain.history["train_loss"][1:],
                           res_j.history["train_loss"][1:], rtol=HIST_RTOL)


def test_hashed_lanes_take_their_single_fits_batches(toy_csv):
    """Uniform lanes under 'auto' draw their multipliers from their own
    generators where the single fit draws them (dropout 0: nothing else
    draws), so lane i trains on its single fit's batches; its losses
    follow the single fit's as under 'none'
    (tests/test_torch_lanes.py's bar)."""
    d = dict(OVERRIDES, data_file=str(toy_csv), shuffle="auto",
             n_experiments=2)
    cfg = ExperimentConfig.from_dict(torch_bench(**d))
    setups = [texp.ExperimentSetup(cfg, i, "cpu") for i in (1, 2)]
    stacked = tbe._stack_lane_host(cfg, setups, torch.device("cpu"))
    assert len(set(stacked["data"].n_batches)) == 1
    lanes = tm.stack_lane_models([s.model for s in setups])
    fits = tloop.fit_lanes(cfg, setups[0].spec, lanes, stacked["data"],
                           stacked["lr_steps"], stacked["lr_recorded"],
                           [s.experiment_seed for s in setups])
    for s, lane in zip(setups, fits):
        fresh = texp.ExperimentSetup(cfg, s.experiment_id, "cpu")
        single = tloop.fit(cfg, fresh.spec, fresh.model, fresh.train_ps,
                           fresh.valid_ps, seed=fresh.experiment_seed)
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(lane.history[key],
                                       single.history[key], rtol=3e-6,
                                       err_msg=key)
