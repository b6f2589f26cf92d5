"""A real two-process run of the port's CLI on the CPU (the counterpart of
tests/test_multiprocess_cluster.py): `cli/train_st_interp.py` in 2 gloo
ranks, each joining the group through torchrun's environment, with the
three engines.

  - `--engine vmap`, 4 seeds: each process trains and writes its 2 lanes
    only, the primary alone writes the summary, and at dropout 0 with
    `shuffle: none` every lane equals the same seed's lane of a
    single-process batch bit for bit (a lane's arithmetic does not depend
    on the batch's other lanes on the CPU);
  - `--engine dp`: every fit data-parallel over both ranks, only the
    primary writes; the fits match the sequential single-process fits at
    rtol 1e-4 (tests/test_data_parallel.py's bar);
  - `--engine sequential`: the fits stripe over the processes and equal
    the single-process fits bit for bit.
The children run once for the module (`run_ranks`, 60 s group timeout)."""
import json

import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.config import ExperimentConfig, dump_yaml

ENGINES = ("vmap", "dp", "sequential")


def _config(csv, **kw):
    return {**dict(tag="cluster", data_file=str(csv), k_spatial_centers=[9],
                   k_temporal_centers=[4], hidden_dims=[16, 8], dropout=0.0,
                   epochs=4, lr=5e-3, batch_size=64, patience=50,
                   regression_type="multi-quantile",
                   quantile_levels=[0.1, 0.5, 0.9], obs_ratio=0.5,
                   n_experiments=4, base_seed=300, device="cpu",
                   save_plots=False, shuffle="none",
                   spatial_learnable=True), **kw}


def _cluster_rank(rank, yaml_path, out_root):
    """The CLI with each engine; the experiments this process finalized."""
    from st_dadk_tpu_torch.cli import train_st_interp as cli
    from st_dadk_tpu_torch.train import batch_engine, experiment
    written = []
    for mod in (batch_engine, experiment):
        orig = mod.finalize_experiment

        def record(cfg, setup, *a, _orig=orig, **kw):
            if kw.get("write_artifacts", True):
                written.append(setup.experiment_id)
            return _orig(cfg, setup, *a, **kw)
        mod.finalize_experiment = record
    out = {}
    for engine in ENGINES:
        written.clear()
        summary = cli.main(["--config", yaml_path, "--engine", engine,
                            "--output_dir", f"{out_root}/{engine}"])
        out[engine] = {"summary": summary is not None,
                       "written": sorted(set(written))}
    return out


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from st_dadk_tpu_torch.parallel.launch import run_ranks
    from st_dadk_tpu_torch.train.runner import run_multiple_experiments
    d = tmp_path_factory.mktemp("cluster")
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (d / "toy.csv").write_text("\n".join(lines))
    cfg = _config(d / "toy.csv")
    (d / "c.yaml").write_text(dump_yaml(cfg))
    ranks = run_ranks(_cluster_rank, 2, (str(d / "c.yaml"), str(d / "mp")),
                      init="torchrun")
    # the children run one torch thread; so does the reference here, whose
    # CPU sums would otherwise split over other threads
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = {e: run_multiple_experiments(
            ExperimentConfig.from_dict(cfg), d / "single" / e, engine=e,
            device="cpu") for e in ("vmap", "sequential")}
    finally:
        torch.set_num_threads(threads)
    return d, ranks, single


def _results(root, i):
    return json.loads((root / "experiments" / str(i) / "results.json")
                      .read_text())


@pytest.mark.parametrize("engine", ENGINES)
def test_every_experiment_written_and_summarised_once(cluster, engine):
    d, ranks, _ = cluster
    root = d / "mp" / engine
    for i in range(1, 5):
        assert (root / "experiments" / str(i) / "results.json").exists()
    assert [r[engine]["summary"] for r in ranks] == [True, False]
    stats = json.loads((root / "summary" / "summary_statistics.json")
                       .read_text())
    assert stats["n_experiments"] == 4
    assert (root / "config.yaml").exists()


@pytest.mark.parametrize("engine,want", [
    ("vmap", ([1, 2], [3, 4])),           # each process its lane slice
    ("sequential", ([1, 3], [2, 4])),     # fits striped over processes
    ("dp", ([1, 2, 3, 4], []))])          # every fit on both, primary writes
def test_each_process_writes_only_its_own(cluster, engine, want):
    _, ranks, _ = cluster
    assert (ranks[0][engine]["written"], ranks[1][engine]["written"]) == want


@pytest.mark.parametrize("engine", ["vmap", "sequential"])
def test_lanes_and_stripes_equal_the_single_process_run(cluster, engine):
    d, _, _ = cluster
    for i in range(1, 5):
        got = _results(d / "mp" / engine, i)
        want = _results(d / "single" / engine, i)
        assert got["training_history"] == want["training_history"]
        for m in ("test_rmse", "test_crps", "valid_rmse"):
            assert got[m] == want[m], (i, m)


def test_dp_fits_match_the_single_process_fits(cluster):
    d, _, _ = cluster
    for i in range(1, 5):
        got = _results(d / "mp" / "dp", i)["training_history"]
        want = _results(d / "single" / "sequential", i)["training_history"]
        for k in ("train_loss", "val_loss", "val_rmse"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{i} {k}")
