"""The data-parallel fit of the port (`train/loop.py::fit(dp=...)`,
`parallel/data_parallel.py`) in 2-rank gloo children on the CPU, against
the port's single fit and the JAX package's data-parallel fit (JAX
`fit(mesh=...)` on the 8-device CPU mesh of tests/conftest.py).

Bars: a 2-rank fit against the single fit at rtol 1e-4 / atol 1e-5 with
dropout on (tests/test_data_parallel.py's bar for 8 devices against 1);
the loss of a batch whose pad rows all sit on one rank against the
unsharded objective at rtol 1e-5; the port's dp fit against JAX's dp8 fit
at dropout 0 with `shuffle: none` by tests/test_torch_fit.py's bars
(histories rtol 1e-4, centers atol 1e-5). The children run once for the
module (`run_ranks`, 60 s group timeout)."""
import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.config import ExperimentConfig
from torch_threads import worker_threads  # noqa: F401

HIST_RTOL = 1e-4       # tests/test_torch_fit.py
DP_RTOL, DP_ATOL = 1e-4, 1e-5


def _base(csv, **kw):
    d = dict(data_file=str(csv), k_spatial_centers=[4, 9],
             k_temporal_centers=[5], hidden_dims=[32, 16], dropout=0.1,
             epochs=6, lr=5e-3, batch_size=64, patience=50, warmup_epochs=1,
             scheduler="cosine", grad_clip=10.0, weight_decay=1e-5,
             regression_type="multi-quantile",
             quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
             spatial_learnable=True, basis_unfreeze_epoch=1,
             gradient_damping=True, domain_penalty_weight=0.01,
             obs_ratio=0.5, spatial_init_method="uniform", device="cpu")
    d.update(kw)
    return d


JAX_OVERRIDES = dict(dropout=0.0, epochs=3, shuffle="none",
                     basis_lr_rampup_epochs=2, regression_type="multi-quantile")


def _fit(cfg_dict, dp, params=None, consts=None):
    from st_dadk_tpu_torch.models.st_interp import from_jax_params
    from st_dadk_tpu_torch.train.experiment import ExperimentSetup
    from st_dadk_tpu_torch.train.loop import fit
    cfg = ExperimentConfig.from_dict(cfg_dict)
    s = ExperimentSetup(cfg, 1, "cpu", defer_model=params is not None)
    if params is not None:
        s.model = from_jax_params(s.spec, params, consts, device="cpu")
    r = fit(cfg, s.spec, s.model, s.train_ps, s.valid_ps,
            seed=s.experiment_seed, dp=dp)
    return {"history": r.history, "params": r.params,
            "n_epochs_run": r.n_epochs_run, "stopped": r.stopped_early}


def _uneven_batch():
    """64 rows, the last 24 pads (weight 0): all of rank 1's 32 rows but 8."""
    rng = np.random.default_rng(7)
    n = 64
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    t = rng.uniform(size=(n, 1)).astype(np.float32)
    y = rng.normal(size=(n, 1)).astype(np.float32)
    w = np.ones(n, np.float32)
    w[40:] = 0.0
    return coords, t, y, w


def _small_model():
    from st_dadk_tpu_torch.models.st_interp import ModelSpec, init_model
    spec = ModelSpec(k_spatial_centers=(9,), k_temporal_centers=(4,),
                     hidden_dims=(16, 8), dropout=0.0,
                     spatial_learnable=True)
    return spec, init_model(torch.Generator().manual_seed(1), spec,
                            device="cpu")


def _dp_rank(rank, cfgs, jax_init):
    """Every port-side run of this module on one rank of the group."""
    from st_dadk_tpu_torch.parallel.data_parallel import (DPGroup,
                                                          make_dp_train_step,
                                                          rank_generator)
    from st_dadk_tpu_torch.train.loop import LoopSpec
    from st_dadk_tpu_torch.train.optimizer import AdamW
    dp = DPGroup.default("cpu")
    out = {"fit": _fit(cfgs["dropout"], dp),
           "stop": _fit(cfgs["stop"], dp),
           "jax": _fit(cfgs["jax"], dp, *jax_init)}
    # make_dp_train_step on the uneven batch: rank r gets rows r*32..
    spec, model = _small_model()
    cfg = ExperimentConfig.from_dict(dict(
        k_spatial_centers=[9], k_temporal_centers=[4], hidden_dims=[16, 8],
        dropout=0.0, regression_type="mean", spatial_learnable=True))
    lspec = LoopSpec.from_config(cfg, spec, 64, 1, 64, 1)
    opt = AdamW({"mlp": list(model.mlp.parameters()),
                 "basis": list(model.basis.parameters())}, 0.0)
    step = make_dp_train_step(lspec, model, opt,
                              [p.detach().clone() for p in
                               model.parameters()], dp)
    rows = dp.rows(64)
    coords, t, y, w = (torch.as_tensor(a[rows]) for a in _uneven_batch())
    out["uneven_loss"] = step(coords, t, y, w, {"mlp": 1e-2, "basis": 1e-3},
                              0.9, rank_generator(0, dp))
    out["uneven_params"] = {n: p.detach().numpy().copy()
                            for n, p in model.named_parameters()}
    return out


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_toy")
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
def jax_side(toy_csv):
    """JAX's setup of experiment 1 (its init carried to the port) and its
    dp8 fit at dropout 0 under shuffle 'none'."""
    import jax
    from jax.sharding import Mesh

    from st_dadk_tpu.config import ExperimentConfig as JaxConfig
    from st_dadk_tpu.train import experiment as jexp
    from st_dadk_tpu.train import loop as jloop
    cfg = JaxConfig.from_dict(_base(toy_csv, **JAX_OVERRIDES, device="cpu"))
    s = jexp.ExperimentSetup(cfg, 1)
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    r = jloop.fit(cfg, s.spec, s.params, s.consts, s.train_ps, s.valid_ps,
                  seed=s.experiment_seed, mesh=mesh)
    init = (jax.tree_util.tree_map(np.asarray, s.params),
            {k: np.asarray(v) for k, v in s.consts.items()})
    return init, r


@pytest.fixture(scope="module")
def runs(toy_csv, jax_side):
    from st_dadk_tpu_torch.parallel.launch import run_ranks
    cfgs = {"dropout": _base(toy_csv),
            "stop": _base(toy_csv, epochs=40, patience=2, lr=5e-2),
            "jax": _base(toy_csv, **JAX_OVERRIDES)}
    ranks = run_ranks(_dp_rank, 2, (cfgs, jax_side[0]))
    single = {"dropout": _fit(cfgs["dropout"], None),
              "stop": _fit(cfgs["stop"], None)}
    return cfgs, ranks, single


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_two_rank_fit_matches_the_single_fit(runs):
    """Dropout on: every rank draws the minibatch's whole mask block and
    takes its rows, so the 2-rank fit is the single fit up to the order of
    float32 sums."""
    _, ranks, single = runs
    got, want = ranks[0]["fit"], single["dropout"]
    assert got["n_epochs_run"] == want["n_epochs_run"] == 6
    for k in ("train_loss", "val_loss", "val_rmse"):
        np.testing.assert_allclose(got["history"][k], want["history"][k],
                                   rtol=DP_RTOL, atol=DP_ATOL, err_msg=k)
    fg, fw = _flat(got["params"]), _flat(want["params"])
    for k in fw:
        np.testing.assert_allclose(fg[k], fw[k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_ranks_hold_bitwise_equal_replicas(runs):
    _, ranks, _ = runs
    for run in ("fit", "stop", "jax"):
        a, b = _flat(ranks[0][run]["params"]), _flat(ranks[1][run]["params"])
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{run} {k}")
        for k in ("train_loss", "val_loss", "val_rmse"):
            np.testing.assert_array_equal(ranks[0][run]["history"][k],
                                          ranks[1][run]["history"][k])


def test_uneven_padding_loss_is_the_global_objective(runs):
    """Rank 1 holds 8 real rows and 24 pads: the mean over ranks of the
    share-scaled losses is the unsharded weighted loss, and the update is
    the unsharded update."""
    from st_dadk_tpu_torch.train.loop import LoopSpec, training_loss
    from st_dadk_tpu_torch.train.optimizer import AdamW
    _, ranks, _ = runs
    spec, model = _small_model()
    cfg = ExperimentConfig.from_dict(dict(
        k_spatial_centers=[9], k_temporal_centers=[4], hidden_dims=[16, 8],
        dropout=0.0, regression_type="mean", spatial_learnable=True))
    lspec = LoopSpec.from_config(cfg, spec, 64, 1, 64, 1)
    coords, t, y, w = (torch.as_tensor(a) for a in _uneven_batch())
    loss = training_loss(lspec, model, coords, t, y, w, train=True,
                         generator=None)
    loss.backward()
    from st_dadk_tpu_torch.train.loop import _transform_grads
    _transform_grads(lspec, model)
    AdamW({"mlp": list(model.mlp.parameters()),
           "basis": list(model.basis.parameters())}, 0.0).step(
        {"mlp": 1e-2, "basis": 1e-3})
    for r in ranks:
        assert r["uneven_loss"] == pytest.approx(float(loss.detach()),
                                                 rel=1e-5)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(ranks[0]["uneven_params"][n],
                                   p.detach().numpy(), atol=5e-6, err_msg=n)


def test_early_stopping_ranks_stop_together(runs):
    _, ranks, single = runs
    stops = [r["stop"]["n_epochs_run"] for r in ranks]
    assert stops[0] == stops[1] == single["stop"]["n_epochs_run"] < 40
    assert all(r["stop"]["stopped"] for r in ranks)


def test_dp_fit_matches_jax_dp8(runs, jax_side):
    """JAX's init carried across, dropout 0, identity batch order: the
    port over 2 ranks against JAX over 8 devices."""
    _, ranks, _ = runs
    _, r_j = jax_side
    got = ranks[0]["jax"]
    assert got["n_epochs_run"] == r_j.n_epochs_run == 3
    for k in ("train_loss", "val_loss", "val_rmse"):
        np.testing.assert_allclose(got["history"][k], r_j.history[k],
                                   rtol=HIST_RTOL, err_msg=k)
    np.testing.assert_allclose(got["params"]["basis"]["centers"],
                               np.asarray(r_j.params["basis"]["centers"]),
                               atol=1e-5)
