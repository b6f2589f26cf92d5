"""Tail compaction of the lane engine (`tail_compaction: true`,
st_dadk_tpu_torch/train/loop.py::fit_lanes) against the uncompacted batch,
under the JAX package's test setting (tests/test_batch_engine.py:179-216):
8 lanes, patience 1, compaction at epoch 60 of 120, shuffle 'perm', lanes
stopping on both sides of the compaction point; test and validation RMSE
at rtol 1e-6, loss histories at rtol 1e-5, equal stop epochs. Also with
dropout on (the narrowed batch keeps each lane's rows of the full-width
draw), with the packed optimizer, and with center trajectories recorded
(`test_compaction_with_center_trajectories`)."""
import numpy as np
import pytest

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.train import batch_engine as tbe
from st_dadk_tpu_torch.train import loop as tloop
from torch_threads import worker_threads  # noqa: F401


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    """tests/test_batch_engine.py's toy field."""
    d = tmp_path_factory.mktemp("compaction")
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (d / "toy.csv").write_text("\n".join(lines))
    return d / "toy.csv"


def _cfg(toy_csv, **kw):
    """tests/test_batch_engine.py's `_cfg`."""
    return ExperimentConfig.from_dict({**dict(
        tag="batchtest", data_file=str(toy_csv), k_spatial_centers=[9],
        k_temporal_centers=[4], hidden_dims=[16, 8], dropout=0.0, epochs=8,
        lr=5e-3, batch_size=64, patience=50, warmup_epochs=1,
        scheduler="cosine", grad_clip=10.0, regression_type="mean",
        obs_method="site-wise", obs_ratio=0.5, obs_spatial_pattern="uniform",
        split_method="random", train_ratio=0.8, n_experiments=4,
        base_seed=100, save_plots=False, save_artifacts=False), **kw})


def _run(cfg, out, n):
    return tbe.run_job_batch([(cfg, i, out / str(i)) for i in range(1, n + 1)],
                             device="cpu", verbose=True)


def _same(r_full, r_comp):
    for a, b in zip(r_full, r_comp):
        assert a["experiment_seed"] == b["experiment_seed"]
        assert a["n_epochs_run"] == b["n_epochs_run"]
        np.testing.assert_allclose(a["test_rmse"], b["test_rmse"], rtol=1e-6)
        np.testing.assert_allclose(a["valid_rmse"], b["valid_rmse"],
                                   rtol=1e-6)
        for k in ("train_loss", "val_loss"):
            ha, hb = a["training_history"][k], b["training_history"][k]
            assert len(ha) == len(hb)
            np.testing.assert_allclose(ha, hb, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("extra", [
    dict(),
    dict(dropout=0.1),
    dict(packed_optimizer=True),
], ids=["jax_setting", "dropout", "packed"])
def test_compacted_equals_full_width(toy_csv, tmp_path, capsys, extra):
    cfg = _cfg(toy_csv, epochs=120, patience=1, n_experiments=8,
               extra={"shuffle": "perm"}, compaction_epoch=60, **extra)
    r_full = _run(cfg, tmp_path / "full", 8)
    capsys.readouterr()
    r_comp = _run(cfg.replace(tail_compaction=True), tmp_path / "comp", 8)
    out = capsys.readouterr().out
    stops = [r["n_epochs_run"] for r in r_full]
    # lanes stop on both sides of the compaction point, and the batch
    # narrows to the active lanes padded to a multiple of 4
    assert min(stops) < 60 < max(stops), stops
    active = sum(s > 60 for s in stops)
    width = -(-active // 4) * 4
    assert width < 8
    assert (f"tail compaction 8->{width} lanes at epoch 60 ({active} active)"
            in out), out
    _same(r_full, r_comp)


def test_compaction_with_center_trajectories(toy_csv, tmp_path):
    """A learnable basis records center trajectories (every 100 epochs)
    across a compaction point that is not a multiple of 100: results and
    the recorded centers equal the uncompacted run's."""
    cfg = _cfg(toy_csv, epochs=200, patience=1, n_experiments=4,
               spatial_learnable=True, spatial_init_method="uniform",
               compaction_epoch=120)
    calls = {}
    orig = tloop.fit_lanes

    def spy(*a, **kw):
        res = orig(*a, **kw)
        calls.setdefault("fits", []).append(res)
        return res
    tbe.fit_lanes, saved = spy, tbe.fit_lanes
    try:
        r_full = _run(cfg, tmp_path / "cf", 4)
        r_comp = _run(cfg.replace(tail_compaction=True), tmp_path / "cc", 4)
    finally:
        tbe.fit_lanes = saved
    for a, b in zip(r_full, r_comp):
        np.testing.assert_allclose(a["test_rmse"], b["test_rmse"], rtol=1e-6)
    full, comp = calls["fits"]
    for a, b in zip(full, comp):
        assert [e for e, _ in a.centers_history] == \
            [e for e, _ in b.centers_history]
        for (_, ca), (_, cb) in zip(a.centers_history, b.centers_history):
            np.testing.assert_allclose(ca, cb, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(a.center_shift, b.center_shift,
                                   rtol=1e-6, atol=1e-7)


def test_compaction_width_rule():
    """JAX's width rule on one device: q = max(M // 4, 4), the next
    multiple of q above the active count, narrowing only below M, padded
    with distinct stopped lanes."""
    stopped = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    sel = tloop._compaction_width(stopped)
    assert sel.tolist() == [1, 4, 0, 2]
    assert tloop._compaction_width(np.array([0] * 5 + [1] * 3, bool)) is None
    assert tloop._compaction_width(np.ones(8, bool)) is None
    wide = np.ones(20, bool)
    wide[[3, 7, 11, 15, 19, 2]] = False
    sel = tloop._compaction_width(wide)
    assert len(sel) == 10 and len(set(sel.tolist())) == 10
    assert set(np.flatnonzero(~wide)) <= set(sel.tolist())
