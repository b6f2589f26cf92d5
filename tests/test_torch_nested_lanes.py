"""Lanes nested over an 'exp' x 'data' mesh: `train/loop.py::fit_lanes(dp=
...)` and `train/batch_engine.py::owned_lane_slice` on 4 gloo ranks laid
out 2 x 2 (`parallel/launch.py::run_ranks`), on the CPU.

- Against JAX's hybrid run (tests/test_data_parallel.py:143-196: lanes
  sharded over 'exp', each lane's minibatch over 'data', on the 8-device
  CPU mesh of tests/conftest.py) with JAX's params carried in, dropout 0
  and `shuffle: none`, lane for lane: train loss and validation RMSE at
  that test's bar, rtol 1e-4 / atol 1e-5.
- Against the port's single-process `fit_lanes` of the same lanes with
  dropout and the shuffle on, and again with the packed optimizer and tail
  compaction: every rank draws the whole minibatch's masks and order and
  takes its rows in the split's order, so the nested fit is the
  single-process fit up to the order of its float32 sums. In a few epochs
  of a toy fit that is tests/test_torch_data_parallel.py's bar for 2 ranks
  against 1 (rtol 1e-4 / atol 1e-5); the replicas of a data row bitwise
  equal.
- Through the lane engine (`run_job_batch(mesh=...)`): each data row owns
  the lanes of its 'exp' coordinate, and only its rank 0 writes them, one
  write a lane.

The children run once for the module. This file's top level imports
nothing of JAX: every child runs it."""
import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.bench_workload import bench_workload
from st_dadk_tpu_torch.config import ExperimentConfig
from torch_threads import worker_threads  # noqa: F401

LANES = 4
MESH = {"exp": 2, "data": 2}
RTOL, ATOL = 1e-4, 1e-5          # tests/test_data_parallel.py:190-196
KEYS = ("train_loss", "val_loss", "val_rmse")


def _base(csv, **kw):
    d = dict(data_file=str(csv), k_spatial_centers=[4, 9],
             k_temporal_centers=[5], hidden_dims=[32, 16], dropout=0.1,
             epochs=4, lr=5e-3, batch_size=32, patience=50, warmup_epochs=1,
             scheduler="cosine", grad_clip=10.0, weight_decay=1e-5,
             regression_type="multi-quantile",
             quantile_levels=[0.05, 0.25, 0.5, 0.75, 0.95],
             spatial_learnable=True, basis_unfreeze_epoch=1,
             basis_lr_rampup_epochs=2, gradient_damping=True,
             domain_penalty_weight=0.01, obs_ratio=0.5,
             spatial_init_method="uniform", device="cpu",
             save_plots=False, save_artifacts=False)
    d.update(kw)
    return d


JAX_OVERRIDES = dict(dropout=0.0, shuffle="none")
# the packed optimizer, and tail compaction: 8 lanes a row, of which 6 of
# lanes 1-8 stop at epoch 2 (an epoch gaining under a fifth of the best
# validation loss stops a lane), so that row narrows to 4 lanes there
OPTIONS = dict(shuffle="auto", packed_optimizer=True, tail_compaction=True,
               compaction_epoch=2, patience=1, early_stop_min_rel_delta=0.2,
               epochs=6)
OPTION_LANES = 16


def _setups(cfg, ids, init=None):
    """The port's setups of experiments `ids`, each model from JAX's
    (params, consts) where `init` holds them (a list over ids)."""
    from st_dadk_tpu_torch.models.st_interp import from_jax_params
    from st_dadk_tpu_torch.train.experiment import ExperimentSetup
    out = []
    for j, i in enumerate(ids):
        s = ExperimentSetup(cfg, i, "cpu", defer_model=init is not None)
        if init is not None:
            s.model = from_jax_params(s.spec, *init[j], device="cpu")
        out.append(s)
    return out


def _fit_lanes(cfg_dict, ids, init=None, dp=None, narrowed=None):
    """fit_lanes over the lanes `ids` (their histories and serving
    params); `narrowed` collects whether each compaction try narrowed."""
    from st_dadk_tpu_torch.models.st_interp import stack_lane_models
    from st_dadk_tpu_torch.train import batch_engine as tbe
    from st_dadk_tpu_torch.train import loop
    cfg = ExperimentConfig.from_dict(bench_workload(**cfg_dict))
    setups = _setups(cfg, ids, init)
    stacked = tbe._stack_lane_host(cfg, setups, torch.device("cpu"))
    width = loop._compaction_width
    if narrowed is not None:
        loop._compaction_width = lambda stopped: (
            lambda sel: narrowed.append(sel is not None) or sel)(
            width(stopped))
    try:
        res = loop.fit_lanes(cfg, setups[0].spec,
                             stack_lane_models([s.model for s in setups]),
                             stacked["data"], stacked["lr_steps"],
                             stacked["lr_recorded"],
                             [s.experiment_seed for s in setups], dp=dp)
    finally:
        loop._compaction_width = width
    return [{"history": r.history, "params": r.params,
             "n_epochs_run": r.n_epochs_run} for r in res]


def _nested_rank(rank, cfgs, jax_init, out_root):
    """One rank of the 2 x 2 mesh: its lanes (`owned_lane_slice`) through
    fit_lanes over its data row, twice; then the lane engine's batch."""
    from st_dadk_tpu_torch.parallel.data_parallel import DPGroup
    from st_dadk_tpu_torch.parallel.mesh import make_mesh
    from st_dadk_tpu_torch.train import batch_engine as tbe
    mesh = make_mesh(MESH)
    sl = tbe.owned_lane_slice(LANES, mesh)
    dp = DPGroup.from_mesh(mesh, "cpu", "data")
    ids = list(range(sl.start + 1, sl.stop + 1))
    wide = tbe.owned_lane_slice(OPTION_LANES, mesh)
    wide_ids = list(range(wide.start + 1, wide.stop + 1))
    narrowed = []
    out = {"lanes": ids, "row": (dp.rank, dp.world),
           "jax": _fit_lanes(cfgs["jax"], ids, jax_init[sl], dp),
           "dropout": _fit_lanes(cfgs["dropout"], ids, None, dp),
           "option_lanes": wide_ids,
           "options": _fit_lanes(cfgs["options"], wide_ids, None, dp,
                                 narrowed),
           "narrowed": narrowed}
    written = []
    orig = tbe.finalize_experiment

    def record(cfg_, setup, result, *a, **kw):
        written.append(setup.experiment_id)
        return orig(cfg_, setup, result, *a, **kw)
    tbe.finalize_experiment = record
    cfg = ExperimentConfig.from_dict(bench_workload(**cfgs["engine"]))
    jobs = [(cfg, i, f"{out_root}/{i}") for i in range(1, LANES + 1)]
    res = tbe.run_job_batch(jobs, mesh=mesh)
    tbe.finalize_experiment = orig
    out["written"] = written
    out["engine"] = {r["experiment_id"]: r["training_history"] for r in res}
    return out


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    """The toy field of tests/test_torch_lanes.py."""
    d = tmp_path_factory.mktemp("nested_toy")
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
    """JAX's setups of experiments 1..LANES (their init carried to the
    port) and its hybrid {'exp': 4, 'data': 2} lane run."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from st_dadk_tpu.bench_workload import bench_workload as jax_bench
    from st_dadk_tpu.config import ExperimentConfig as JaxConfig
    from st_dadk_tpu.train import batch_engine as jbe
    from st_dadk_tpu.train import experiment as jexp
    from st_dadk_tpu.train import loop as jloop

    cfg = JaxConfig.from_dict(jax_bench(**_base(toy_csv, **JAX_OVERRIDES)))
    setups = [jexp.ExperimentSetup(cfg, i) for i in range(1, LANES + 1)]
    stacked = jbe._stack_lane_host(cfg, setups)
    spec = jloop.LoopSpec.from_config(
        cfg, setups[0].spec, stacked["batch_size"], stacked["B_shared"],
        stacked["val_chunk"], stacked["n_val_chunks"])
    if any(int(d.n_batches) != stacked["B_shared"] for d in stacked["datas"]):
        spec = dataclasses.replace(spec, uniform_lanes=False)
    stack = lambda trees: jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *trees)
    carry_b = stack([jloop.init_carry(s.params,
                                      jax.random.PRNGKey(s.experiment_seed))
                     for s in setups])
    consts_b = stack([s.consts for s in setups])
    data_b = jax.tree_util.tree_map(jnp.asarray, stacked["data_b"])
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("exp", "data"))
    lane = lambda t: jax.device_put(t, NamedSharding(mesh, P("exp")))
    E = cfg.epochs
    fit_chunk = jloop.jitted_fit_chunk(
        dataclasses.replace(spec, dp_axis="data"), vmapped=True,
        lr_per_lane=True, mesh=mesh, spmd_axis="exp")
    _, hist = fit_chunk(lane(carry_b), lane(consts_b), lane(data_b),
                        jnp.arange(E, dtype=jnp.int32),
                        lane(jnp.asarray(stacked["lr_steps"])),
                        jnp.ones((E,), bool))
    init = [(jax.tree_util.tree_map(np.asarray, s.params),
             {k: np.asarray(v) for k, v in s.consts.items()})
            for s in setups]
    return init, {k: np.asarray(hist[k]) for k in KEYS}


@pytest.fixture(scope="module")
def runs(toy_csv, jax_side, tmp_path_factory):
    from st_dadk_tpu_torch.parallel.launch import run_ranks
    cfgs = {"jax": _base(toy_csv, **JAX_OVERRIDES),
            "dropout": _base(toy_csv, shuffle="auto"),
            "options": _base(toy_csv, **OPTIONS),
            "engine": _base(toy_csv, save_artifacts=True)}
    out_root = tmp_path_factory.mktemp("nested_engine")
    init = np.empty(LANES, dtype=object)
    init[:] = jax_side[0]
    ranks = run_ranks(_nested_rank, 4, (cfgs, init, str(out_root)))
    single = {("dropout", tuple(r["lanes"])): _fit_lanes(cfgs["dropout"],
                                                         r["lanes"])
              for r in ranks[::2]}
    narrowed = []
    for r in ranks[::2]:
        lanes = tuple(r["option_lanes"])
        single[("options", lanes)] = _fit_lanes(cfgs["options"], lanes,
                                                narrowed=narrowed)
    single["narrowed"] = narrowed
    return ranks, single, out_root


def test_rows_own_their_lanes(runs):
    ranks, _, _ = runs
    assert [r["lanes"] for r in ranks] == [[1, 2], [1, 2], [3, 4], [3, 4]]
    assert [r["row"] for r in ranks] == [(0, 2), (1, 2), (0, 2), (1, 2)]


def test_nested_lanes_match_jax_hybrid(runs, jax_side):
    """JAX's init, dropout 0, identity batch order: lane for lane against
    JAX's exp x data run."""
    ranks, _, _ = runs
    _, hist = jax_side
    for r in ranks:
        for lane, got in zip(r["lanes"], r["jax"]):
            assert got["n_epochs_run"] == hist["train_loss"].shape[1]
            for k in ("train_loss", "val_rmse"):
                np.testing.assert_allclose(got["history"][k],
                                           hist[k][lane - 1], rtol=RTOL,
                                           atol=ATOL, err_msg=f"{k} {lane}")


@pytest.mark.parametrize("run", ["dropout", "options"])
def test_nested_lanes_match_single_process_lanes(runs, run):
    """Dropout and the shuffle on (and the packed optimizer with tail
    compaction): the row's fit against one process's fit_lanes of the same
    lanes."""
    ranks, single, _ = runs
    for r in ranks:
        want = single[(run, tuple(r["lanes" if run == "dropout"
                                    else "option_lanes"]))]
        assert len(r[run]) == len(want)
        for got, ref in zip(r[run], want):
            assert got["n_epochs_run"] == ref["n_epochs_run"]
            if run == "dropout":
                assert got["n_epochs_run"] == 4
            for k in KEYS:
                np.testing.assert_allclose(got["history"][k],
                                           ref["history"][k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)
    if run == "options":
        # tail compaction narrowed a row, as it did in one process
        assert any(single["narrowed"]) and any(ranks[0]["narrowed"])
        assert [r["narrowed"] for r in ranks[::2]] == [
            single["narrowed"][:len(ranks[0]["narrowed"])],
            single["narrowed"][len(ranks[0]["narrowed"]):]]
        return
    a, b = ranks[0]["dropout"][0]["history"], ranks[2]["dropout"][0]["history"]
    assert abs(a["val_loss"][-1] - b["val_loss"][-1]) > 1e-4   # lanes differ


def test_data_row_replicas_are_bitwise_equal(runs):
    ranks, _, _ = runs
    for lo, hi in ((0, 1), (2, 3)):
        for run in ("jax", "dropout", "options"):
            for a, b in zip(ranks[lo][run], ranks[hi][run]):
                for k in KEYS:
                    np.testing.assert_array_equal(a["history"][k],
                                                  b["history"][k])
                for g in a["params"]:
                    for name, v in a["params"][g].items():
                        if isinstance(v, dict):
                            for n2, v2 in v.items():
                                np.testing.assert_array_equal(
                                    v2, b["params"][g][name][n2])
                        else:
                            np.testing.assert_array_equal(
                                v, b["params"][g][name])


def test_lane_engine_writes_each_lane_once(runs):
    """run_job_batch(mesh=exp x data): rank 0 of each data row finalizes
    and writes its row's lanes; the other rank writes none."""
    ranks, _, out_root = runs
    assert [sorted(r["written"]) for r in ranks] == [[1, 2], [], [3, 4], []]
    assert [sorted(r["engine"]) for r in ranks] == [[1, 2], [], [3, 4], []]
    for i in range(1, LANES + 1):
        assert (out_root / str(i) / "results.json").exists()
        assert (out_root / str(i) / "model_final.npz").exists()
