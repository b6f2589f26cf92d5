"""The packed optimizer (`packed_optimizer: true`, st_dadk_tpu_torch/train/
packing.py) against the per-leaf step and the JAX package's packed fit:

- the layout is JAX's `pack_spec_for` (groups, leaf order, offsets), and
  packing JAX's params gives JAX's flat vectors bit for bit;
- every parameter and its `.grad` are views of the group buffers and stay
  so through backward, a step and `load_jax_params`;
- packed fits match unpacked ones at JAX's bar (tests/test_train_loop.py:
  153-176: loss and validation RMSE histories rtol 1e-4, atol 1e-6), single
  and lanes, with center damping and the basis clip on;
- a packed fit follows JAX's packed fit for 3 epochs with JAX's params and
  hash multipliers handed across at dropout 0 (tests/test_torch_shuffle.py);
- a packed fit's checkpoint has the structured layout and resumes
  unpacked, and the other way round.
"""
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
from st_dadk_tpu.train.packing import pack_spec_for
from st_dadk_tpu_torch.bench_workload import bench_workload as torch_bench
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.dataio.arrays import PointSet
from st_dadk_tpu_torch.models import st_interp as tm
from st_dadk_tpu_torch.train import batch_engine as tbe
from st_dadk_tpu_torch.train import experiment as texp
from st_dadk_tpu_torch.train import loop as tloop
from st_dadk_tpu_torch.train.packing import PackSpec
from torch_threads import worker_threads  # noqa: F401

RTOL, ATOL = 1e-4, 1e-6           # tests/test_train_loop.py:170-176
HIST_RTOL = 1e-4                  # tests/test_torch_shuffle.py
# JAX's packed test fit: damping, the domain penalty and the basis group
# training from the first epoch
PACKED_KW = dict(spatial_learnable=True, gradient_damping=True,
                 damping_threshold=0.0, damping_strength=5.0,
                 domain_penalty_weight=0.01, basis_lr_ratio=0.05,
                 basis_unfreeze_epoch=0, grad_clip=10.0)


def _synthetic(n=256, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    t = rng.uniform(size=(n, 1)).astype(np.float32)
    y = (np.sin(3 * coords[:, :1]) + np.cos(2 * coords[:, 1:2]) + 0.5 * t
         ).astype(np.float32)
    return PointSet(coords=coords, t=t, y=y, w=np.ones(n, np.float32),
                    n_real=n)


def _cfg(**kw):
    """tests/test_train_loop.py's `_cfg`."""
    return ExperimentConfig.from_dict({**dict(
        k_spatial_centers=[16], k_temporal_centers=[5], hidden_dims=[32, 16],
        dropout=0.0, epochs=6, lr=1e-2, batch_size=64, patience=100,
        warmup_epochs=2, scheduler="cosine", grad_clip=10.0,
        weight_decay=1e-5, regression_type="mean"), **kw})


@pytest.mark.parametrize("delta", [False, True])
def test_layout_and_flat_vectors_are_jaxs(delta):
    d = dict(k_spatial_centers=[4, 9], k_temporal_centers=[5],
             hidden_dims=[32, 16, 8, 8, 8, 8, 8, 8, 8, 8, 8],
             spatial_learnable=True, use_delta_reparameterization=delta,
             regression_type="multi-quantile" if delta else "mean",
             quantile_levels=[0.1, 0.5, 0.9])
    spec_j = jm.spec_from_config(JaxConfig.from_dict(d), use_pallas=False)
    params, consts = jm.init_model(jax.random.PRNGKey(0), spec_j)
    ps_j = pack_spec_for(params)
    model = tm.from_jax_params(tm.spec_from_config(
        ExperimentConfig.from_dict(d)), params, consts, device="cpu")
    layout = PackSpec.for_model(model)
    assert layout.groups == ("mlp", "basis")
    assert layout.group_sizes == {g: ps_j.group_sizes[g]
                                  for g in ("mlp", "basis")}
    # the leaf order: JAX's tree-flatten order (linear_10 before linear_2)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    order = sorted(layout.names, key=lambda n: (layout.slots[n][0],
                                                layout.slots[n][1]))
    by_group = {g: [n for n in order if layout.slots[n][0] == g]
                for g in layout.groups}
    want = {g: [p for p, g2 in zip(paths, ps_j.groups) if g2 == g]
            for g in layout.groups}
    to_path = lambda n: "".join(f"['{x}']" for x in n.split("."))
    assert {g: [to_path(n) for n in ns] for g, ns in by_group.items()} == want
    flat_j = ps_j.pack(params)
    flat_t = layout.pack({n: p.detach() for n, p in model.named_parameters()})
    for g in layout.groups:
        np.testing.assert_array_equal(flat_t[g].numpy(),
                                      np.asarray(flat_j[g]))
    # and back: the views are the structured leaves
    for name, view in layout.views(flat_t).items():
        assert torch.equal(view, dict(model.named_parameters())[name])


def _views_of(model, bufs):
    return PackSpec.for_model(model).params_are_views(model, bufs)


@pytest.mark.parametrize("lanes", [False, True])
def test_grads_and_params_stay_views(lanes):
    """Two backward passes with the gradient buffer zeroed between them:
    `.grad` stays the view and holds autograd's gradient of an unpacked
    copy; an in-place step on the buffer moves the parameters; and
    `load_jax_params` writes through the views."""
    spec = tm.spec_from_config(_cfg(**PACKED_KW))
    models = [tm.init_model(torch.Generator().manual_seed(s), spec,
                            device="cpu") for s in (0, 1)]
    model = tm.stack_lane_models(models) if lanes else models[0]
    plain = tm.stack_lane_models(models) if lanes else \
        tm.from_jax_params(spec, tm.to_jax_params(models[0]),
                           tm.model_consts(models[0]), device="cpu")
    layout = PackSpec.for_model(model)
    bufs = layout.attach(model)
    grads = {g: b.grad for g, b in bufs.items()}
    assert _views_of(model, bufs)
    x = _synthetic(64, 2)
    lead = (2,) if lanes else ()
    c = torch.as_tensor(x.coords).expand(*lead, -1, -1).contiguous()
    t = torch.as_tensor(x.t).expand(*lead, -1, -1).contiguous()
    for step in range(2):
        for g in grads.values():
            g.zero_()
        for p in plain.parameters():
            p.grad = None
        for m in (model, plain):
            m(c, t).square().mean().mul(step + 1).backward()
        assert layout.grads_are_views(model, grads)
        for (n, p), q in zip(model.named_parameters(), plain.parameters()):
            torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=0,
                                       msg=n)
    with torch.no_grad():
        bufs["mlp"].mul_(0.5)
    for p, q in zip(model.mlp.parameters(), plain.mlp.parameters()):
        assert torch.equal(p, 0.5 * q)
    if not lanes:
        fresh = tm.init_model(torch.Generator().manual_seed(7), spec,
                              device="cpu")
        tm.load_jax_params(model, tm.to_jax_params(fresh))
        assert _views_of(model, bufs)
        for n, v in layout.views(bufs).items():
            assert torch.equal(v, dict(fresh.named_parameters())[n])


def test_packed_fit_matches_unpacked():
    train_ps, valid_ps = _synthetic(256, 0), _synthetic(64, 1)
    cfg = _cfg(**PACKED_KW)
    spec = tm.spec_from_config(cfg)
    res = {}
    for packed in (False, True):
        model = tm.init_model(torch.Generator().manual_seed(7), spec,
                              device="cpu")
        res[packed] = tloop.fit(cfg.replace(packed_optimizer=packed), spec,
                                model, train_ps, valid_ps, seed=7)
    for k in ("train_loss", "val_loss", "val_rmse"):
        np.testing.assert_allclose(res[True].history[k],
                                   res[False].history[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert res[True].n_steps == res[False].n_steps
    # the basis trained (damping and the 0.1x clip acted on its buffer)
    c0 = res[False].params["basis"]["centers"]
    assert float(np.abs(res[True].params["basis"]["centers"] - c0).max()) \
        < 1e-4


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    """The toy field of tests/test_torch_fit.py."""
    d = tmp_path_factory.mktemp("packing")
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (d / "toy.csv").write_text("\n".join(lines))
    return d / "toy.csv"


def _lane_fit(cfg, ids=(1, 2, 3)):
    setups = [texp.ExperimentSetup(cfg, i, "cpu") for i in ids]
    stacked = tbe._stack_lane_host(cfg, setups, torch.device("cpu"))
    lanes = tm.stack_lane_models([s.model for s in setups])
    return tloop.fit_lanes(cfg, setups[0].spec, lanes, stacked["data"],
                           stacked["lr_steps"], stacked["lr_recorded"],
                           [s.experiment_seed for s in setups])


def test_packed_lanes_match_unpacked_lanes(toy_csv):
    """Three lanes with dropout and the hash shuffle on: the packed lanes
    draw the same masks and batches, so they follow the unpacked lanes."""
    cfg = ExperimentConfig.from_dict(dict(
        PACKED_KW, data_file=str(toy_csv), k_spatial_centers=[4, 9],
        k_temporal_centers=[5], hidden_dims=[32, 16], dropout=0.1, epochs=6,
        lr=5e-3, batch_size=64, warmup_epochs=1, scheduler="cosine",
        regression_type="multi-quantile", obs_ratio=0.5,
        spatial_init_method="uniform"))
    plain = _lane_fit(cfg)
    packed = _lane_fit(cfg.replace(packed_optimizer=True))
    for a, b in zip(packed, plain):
        for k in ("train_loss", "val_loss", "val_rmse"):
            np.testing.assert_allclose(a.history[k], b.history[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        assert a.n_steps == b.n_steps
        np.testing.assert_allclose(a.params["basis"]["centers"],
                                   b.params["basis"]["centers"], atol=1e-5)


def _jax_multipliers(key, cap):
    return np.array(jax.random.randint(key, (4,), 0, tloop.hash_width(cap),
                                       dtype=jnp.int32))


def test_packed_fit_matches_jax_packed(toy_csv, monkeypatch):
    """Three epochs of both packages' packed fits from JAX's params, with
    JAX's per-epoch hash multipliers handed to the port, dropout 0."""
    d = dict(k_spatial_centers=[4, 9], k_temporal_centers=[5],
             hidden_dims=[32, 16], dropout=0.0, epochs=3, warmup_epochs=1,
             basis_unfreeze_epoch=1, basis_lr_rampup_epochs=2, patience=50,
             obs_ratio=0.5, spatial_init_method="uniform",
             data_file=str(toy_csv), shuffle="auto", packed_optimizer=True)
    cfg_j = JaxConfig.from_dict(jax_bench(**d))
    cfg_t = ExperimentConfig.from_dict(torch_bench(**d))
    assert cfg_j.packed_optimizer and cfg_t.packed_optimizer
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


@pytest.mark.parametrize("first_packed", [True, False])
def test_checkpoint_crosses_between_packed_and_unpacked(tmp_path,
                                                        first_packed):
    """A fit checkpointed after 3 of 6 epochs on one route resumes on the
    other: the file holds the structured layout (the unpacked fit's keys),
    and the resumed fit follows the straight fit of the second route at
    the packed bar (the two routes differ only in the clip's sum order)."""
    cfg = _cfg(**PACKED_KW)
    spec = tm.spec_from_config(cfg)
    train_ps, valid_ps = _synthetic(256, 0), _synthetic(64, 1)

    def run(packed, **kw):
        model = tm.init_model(torch.Generator().manual_seed(3), spec,
                              device="cpu")
        return tloop.fit(cfg.replace(packed_optimizer=packed), spec, model,
                         train_ps, valid_ps, seed=3, epochs_chunk=3, **kw)

    ck = {p: tmp_path / f"{p}.ckpt.npz" for p in (True, False)}
    for p in (True, False):
        run(p, checkpoint_path=ck[p], session_epochs=3)
    keys = {p: set(np.load(ck[p]).files) for p in (True, False)}
    assert keys[True] == keys[False]
    straight = run(not first_packed)
    resumed = run(not first_packed, checkpoint_path=ck[first_packed],
                  resume=True)
    assert resumed.n_epochs_run == straight.n_epochs_run == 6
    for k in ("train_loss", "val_loss", "val_rmse"):
        np.testing.assert_allclose(resumed.history[k], straight.history[k],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
