"""Processes of a cluster in the port (`parallel/multihost.py`,
`parallel/mesh.py`), the counterpart of tests/test_multihost.py and
tests/test_multihost_finalize.py: the layout functions with fake devices
(and the JAX package's `_hybrid_grid` on the same fakes), the single-process
degradations, the lane-row fetches, the lane engine's gating of its
artifacts and the runner's primary aggregation, and a real 2-rank gloo
group joined three ways (explicit arguments, torchrun's environment, JAX's).
"""
import json
import types

import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.parallel import mesh as tmesh
from st_dadk_tpu_torch.parallel import multihost as mh
from st_dadk_tpu_torch.train import batch_engine as tbe
from st_dadk_tpu_torch.train import runner as trunner
from torch_threads import worker_threads  # noqa: F401


class FakeDev:
    def __init__(self, id, process_index, slice_index=None):
        self.id = id
        self.process_index = process_index
        if slice_index is not None:
            self.slice_index = slice_index

    def __repr__(self):
        return f"d{self.id}"


def _pod(n_hosts, per_host, slices=None):
    return [FakeDev(h * per_host + i, h, None if slices is None
                    else h // slices)
            for h in range(n_hosts) for i in range(per_host)]


class TestGrouping:
    def test_groups_by_process(self):
        groups = mh.group_devices_by_dcn(_pod(2, 4))
        assert [[d.id for d in g] for g in groups] == [[0, 1, 2, 3],
                                                       [4, 5, 6, 7]]

    def test_slice_index_wins_over_process(self):
        groups = mh.group_devices_by_dcn(_pod(4, 2, slices=2))
        assert [len(g) for g in groups] == [4, 4]
        assert [d.id for d in groups[0]] == [0, 1, 2, 3]

    def test_ranks_group_by_host(self):
        ranks = [mh.RankDevice(r, r, h) for r, h in
                 enumerate([1, 0, 1, 0])]
        groups = mh.group_devices_by_dcn(ranks)
        assert [[d.id for d in g] for g in groups] == [[1, 3], [0, 2]]

    def test_ordering_is_permutation_invariant(self):
        devs = _pod(2, 4)
        shuffled = [devs[i] for i in
                    np.random.default_rng(0).permutation(len(devs))]
        a = mh.group_devices_by_dcn(devs)
        b = mh.group_devices_by_dcn(shuffled)
        assert [[d.id for d in g] for g in a] == [[d.id for d in g]
                                                  for g in b]


@pytest.mark.parametrize("names,shape,pos", [
    (("exp", "data"), (2, 4), 0), (("exp", "data"), (4, 2), 0),
    (("data", "exp"), (4, 2), 1), (("exp",), (8,), 0)])
def test_hybrid_grid_equals_jax(names, shape, pos):
    """The port's grid on fake devices is the JAX package's, id for id."""
    from st_dadk_tpu.parallel.multihost import _hybrid_grid as jax_grid
    from st_dadk_tpu.parallel.multihost import \
        group_devices_by_dcn as jax_groups
    devs = _pod(2, 4)
    got = mh._hybrid_grid(names, shape, pos, mh.group_devices_by_dcn(devs))
    want = jax_grid(names, shape, pos, jax_groups(devs))
    assert [d.id for d in got.ravel()] == [d.id for d in want.ravel()]


class TestHybridGrid:
    def test_exp_across_hosts_data_within(self):
        grid = mh._hybrid_grid(("exp", "data"), (2, 4), 0,
                               mh.group_devices_by_dcn(_pod(2, 4)))
        for e in range(2):
            assert {grid[e, j].process_index for j in range(4)} == {e}

    def test_errors(self):
        groups = mh.group_devices_by_dcn(_pod(2, 4))
        with pytest.raises(ValueError, match="multiple"):
            mh._hybrid_grid(("exp", "data"), (3, 2), 0, groups)
        with pytest.raises(ValueError):
            mh.hybrid_mesh({"data": 8}, dcn_axis="exp", devices=_pod(2, 4))

    def test_hybrid_mesh_of_ranks(self):
        ranks = [mh.RankDevice(r, r, r // 2) for r in range(4)]
        m = mh.hybrid_mesh({"exp": 2, "data": 2}, devices=ranks)
        assert m.shape == {"exp": 2, "data": 2}
        np.testing.assert_array_equal(m.ranks, [[0, 1], [2, 3]])
        assert m.coords(3) == {"exp": 1, "data": 1}


class TestSingleProcess:
    def test_info_and_primary(self):
        assert mh.process_info() == (1, 0) and mh.is_primary()
        assert mh.local_device() is None

    def test_experiment_mesh_auto_is_one_rank(self):
        m = mh.experiment_mesh_auto()
        assert m.shape == {"exp": 1}
        assert mh.process_lane_slice(12, m) == slice(0, 12)

    def test_shard_lanes_single_process_is_the_tree(self):
        tree = {"a": np.arange(16.0).reshape(8, 2)}
        out = mh.shard_lanes_multihost(tree, mh.experiment_mesh_auto())
        np.testing.assert_array_equal(out["a"], tree["a"])

    def test_timestamp_and_barrier_are_local(self):
        before = mh.shared_timestamp()
        mh.sync_processes()
        assert abs((mh.shared_timestamp() - before).total_seconds()) < 60

    @pytest.mark.parametrize("env", [
        {}, {"MASTER_ADDR": "localhost"},
        {"JAX_COORDINATOR_ADDRESS": "localhost:1"},
        {"TPU_WORKER_HOSTNAMES": "localhost"}])
    def test_initialize_noop_without_a_cluster(self, monkeypatch, env):
        for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                    "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                    "JAX_PROCESS_ID", "TPU_WORKER_HOSTNAMES"):
            monkeypatch.delenv(var, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert mh.maybe_initialize_distributed() is False
        assert not torch.distributed.is_initialized()

    def test_explicit_arguments_must_be_whole(self):
        with pytest.raises(ValueError, match="num_processes"):
            mh.maybe_initialize_distributed("localhost:1")


class TestProcessLaneSlice:
    def _fake_mesh(self, n_hosts=2, lanes=4):
        per = lanes // n_hosts
        devs = np.array([FakeDev(i, i // per) for i in range(lanes)],
                        dtype=object)
        return types.SimpleNamespace(shape={"exp": lanes},
                                     axis_names=("exp",), devices=devs)

    def test_two_process_split(self):
        m = self._fake_mesh(2, 4)
        assert (mh.process_lane_slice(8, m, process_index=0,
                                      process_count=2),
                mh.process_lane_slice(8, m, process_index=1,
                                      process_count=2)) == (slice(0, 4),
                                                            slice(4, 8))

    def test_indivisible_batch_raises(self):
        with pytest.raises(ValueError, match="divide"):
            mh.process_lane_slice(6, self._fake_mesh(2, 4), process_index=0,
                                  process_count=2)

    def test_noncontiguous_layout_raises(self):
        devs = np.array([FakeDev(0, 0), FakeDev(1, 1), FakeDev(2, 0),
                         FakeDev(3, 1)], dtype=object)
        m = types.SimpleNamespace(shape={"exp": 4}, axis_names=("exp",),
                                  devices=devs)
        with pytest.raises(ValueError, match="contiguous"):
            mh.process_lane_slice(4, m, process_index=0, process_count=2)


class TestFetchLaneRows:
    def test_owned_rows_are_a_slice(self):
        x = np.arange(12.0).reshape(6, 2)
        np.testing.assert_array_equal(mh.fetch_lane_rows(x, slice(1, 4)),
                                      x[1:4])
        # a process holding global rows 4..8 as its local rows 0..4
        t = torch.arange(8.0).reshape(4, 2)
        np.testing.assert_array_equal(
            mh.fetch_lane_rows(t, slice(5, 7), owned=slice(4, 8)),
            t[1:3].numpy())

    def test_rows_not_held_raise(self):
        with pytest.raises(ValueError, match="process_lane_slice"):
            mh.fetch_lane_rows(np.zeros((4, 2)), slice(2, 6),
                               owned=slice(4, 8))

    def test_no_rows_is_empty(self):
        out = mh.fetch_lane_rows(np.zeros((4, 3)), slice(4, 4),
                                 owned=slice(4, 8))
        assert out.shape == (0, 3)

    def test_tree_variant(self):
        tree = {"a": np.arange(8.0).reshape(4, 2),
                "b": {"c": np.arange(4.0)}}
        out = mh.fetch_lane_tree(tree, slice(1, 3))
        np.testing.assert_array_equal(out["a"], tree["a"][1:3])
        np.testing.assert_array_equal(out["b"]["c"], tree["b"]["c"][1:3])


def test_mesh_maps_lane_rows_to_ranks():
    ranks = [mh.RankDevice(r, r) for r in range(4)]
    m = tmesh.make_mesh({"exp": 2, "data": 2}, ranks)
    assert tmesh.lane_sharding(m, "exp").ranks_of(5, 8) == [2, 3]
    assert tmesh.lane_sharding(m, "data").ranks_of(0, 8) == [0, 2]
    assert tmesh.replicated(m).ranks_of(3, 8) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="needs"):
        tmesh.make_mesh({"exp": 3}, ranks)


# -- the lane engine's gating and the runner's aggregation (one process) ----

@pytest.fixture
def toy_csv(tmp_path):
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (tmp_path / "toy.csv").write_text("\n".join(lines))
    return tmp_path / "toy.csv"


def _cfg(csv, **kw):
    return ExperimentConfig.from_dict({**dict(
        tag="mh", data_file=str(csv), k_spatial_centers=[9],
        k_temporal_centers=[4], hidden_dims=[16, 8], dropout=0.0, epochs=3,
        lr=5e-3, batch_size=64, patience=50, regression_type="mean",
        obs_ratio=0.5, n_experiments=2, base_seed=100, device="cpu",
        save_plots=False, shuffle="none"), **kw})


def test_owned_slice_single_process_is_all():
    assert tbe.owned_lane_slice(4, None) == slice(0, 4)
    assert tbe.owned_lane_slice(3, tmesh.make_mesh()) == slice(0, 3)


def test_half_batch_gating_partitions_artifacts(toy_csv, tmp_path,
                                                monkeypatch):
    """Each 'process' of a fake 2-process cluster writes only its own lanes
    of a batch; its lanes are those of the whole batch (dropout 0, shuffle
    'none': a lane's numbers do not depend on its neighbours)."""
    cfg = _cfg(toy_csv)
    exp_dir = tmp_path / "experiments"
    jobs = [(cfg, i, exp_dir / str(i)) for i in (1, 2, 3, 4)]
    monkeypatch.setattr(tbe, "owned_lane_slice", lambda n, m, a: slice(0, 2))
    lo = tbe.run_job_batch(jobs)
    assert [r["experiment_id"] for r in lo] == [1, 2]
    assert not (exp_dir / "3" / "results.json").exists()
    monkeypatch.setattr(tbe, "owned_lane_slice", lambda n, m, a: slice(2, 4))
    hi = tbe.run_job_batch(jobs)
    assert [r["experiment_id"] for r in hi] == [3, 4]
    monkeypatch.undo()
    full = tbe.run_job_batch([(c, i, tmp_path / "full" / str(i))
                              for c, i, _ in jobs])
    for gated, whole in zip(lo + hi, full):
        assert gated["training_history"] == whole["training_history"]
        assert gated["test_rmse"] == pytest.approx(whole["test_rmse"],
                                                   rel=1e-6)


def test_non_primary_skips_summary(toy_csv, tmp_path, monkeypatch):
    monkeypatch.setattr(trunner, "is_primary", lambda: False)
    out = tmp_path / "run"
    assert trunner.run_multiple_experiments(_cfg(toy_csv), out,
                                            engine="vmap") is None
    assert not (out / "summary" / "summary_statistics.json").exists()
    assert (out / "experiments" / "1" / "results.json").exists()


def test_primary_aggregates(toy_csv, tmp_path):
    out = tmp_path / "run"
    summary = trunner.run_multiple_experiments(_cfg(toy_csv), out,
                                               engine="vmap")
    assert summary["n_experiments"] == 2
    stats = json.loads((out / "summary" / "summary_statistics.json")
                       .read_text())
    assert stats["n_experiments"] == 2


# -- a real group of two ranks --------------------------------------------

def _group_rank(rank):
    import time
    info = mh.process_info()
    devs = mh.rank_devices()
    m = mh.experiment_mesh_auto()
    if rank == 1:
        time.sleep(1.5)     # the timestamp is the primary's all the same
    stamp = mh.shared_timestamp()
    mh.sync_processes("test")
    sl = mh.process_lane_slice(6, m)
    owned = tbe.owned_lane_slice(5, None)
    hosts = {d.host_index for d in devs}
    return dict(info=info, primary=mh.is_primary(), stamp=stamp,
                ranks=[d.id for d in devs], hosts=hosts, shape=m.shape,
                sl=sl, owned=owned, device=str(mh.local_device()))


@pytest.mark.parametrize("init", ["explicit", "torchrun", "jax"])
def test_two_rank_group(init):
    from st_dadk_tpu_torch.parallel.launch import run_ranks
    a, b = run_ranks(_group_rank, 2, init=init)
    assert (a["info"], b["info"]) == ((2, 0), (2, 1))
    assert a["primary"] and not b["primary"]
    assert a["stamp"] == b["stamp"]
    assert a["ranks"] == b["ranks"] == [0, 1] and a["hosts"] == {0}
    assert a["shape"] == {"exp": 2}
    assert (a["sl"], b["sl"]) == (slice(0, 3), slice(3, 6))
    # 5 lanes pad to 6: rank 1 owns lanes 3, 4 (its padded row is no lane)
    assert (a["owned"], b["owned"]) == (slice(0, 3), slice(3, 5))
    assert a["device"] == b["device"] == "cpu"


def _mesh_rank(rank):
    from st_dadk_tpu_torch.parallel.data_parallel import DPGroup
    m = tmesh.make_mesh({"exp": 2, "data": 2})
    dp = DPGroup.from_mesh(m, "cpu", "data")
    t = dp.all_reduce_(torch.tensor([float(rank)]))
    b = dp.broadcast_(torch.tensor([float(rank)]))
    return dp.rank, dp.world, float(t[0]), float(b[0]), m.coords(rank)


def test_data_axis_of_a_two_by_two_mesh():
    """A 'data' row of an exp x data mesh is its own process group (the
    DeviceMesh's): sums and broadcasts stay within the row."""
    from st_dadk_tpu_torch.parallel.launch import run_ranks
    got = run_ranks(_mesh_rank, 4)
    assert [g[:2] for g in got] == [(0, 2), (1, 2), (0, 2), (1, 2)]
    assert [g[2] for g in got] == [1.0, 1.0, 5.0, 5.0]
    assert [g[3] for g in got] == [0.0, 0.0, 2.0, 2.0]
    assert [g[4] for g in got] == [{"exp": e, "data": d}
                                   for e in (0, 1) for d in (0, 1)]
