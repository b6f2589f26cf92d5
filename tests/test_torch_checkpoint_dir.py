"""The port's checkpoint directory (`st_dadk_tpu_torch/train/checkpoint.py`,
torch.distributed.checkpoint): an interrupted fit resumed from a directory
is the uninterrupted fit bit for bit, as from an npz file, and the
crash-window cases of the JAX package's Orbax backend
(tests/test_checkpoint.py:137-237) hold for its layout: state, then
state.tmp, then state.old."""
import shutil

import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.dataio.arrays import PointSet
from st_dadk_tpu_torch.models.st_interp import init_model, spec_from_config
from st_dadk_tpu_torch.train import checkpoint as tck
from st_dadk_tpu_torch.train.loop import fit
from torch_threads import worker_threads  # noqa: F401


def _synthetic(n, seed):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    t = rng.uniform(size=(n, 1)).astype(np.float32)
    y = (np.sin(3 * coords[:, :1]) + 0.5 * t).astype(np.float32)
    return PointSet(coords=coords, t=t, y=y, w=np.ones(n, np.float32),
                    n_real=n)


def _fit(cfg, **kw):
    spec = spec_from_config(cfg)
    model = init_model(torch.Generator().manual_seed(3), spec, device="cpu")
    return fit(cfg, spec, model, _synthetic(256, 0), _synthetic(64, 1),
               seed=3, **kw)


def _cfg(epochs, **kw):
    return ExperimentConfig.from_dict({**dict(
        k_spatial_centers=[9], k_temporal_centers=[4], hidden_dims=[16, 8],
        dropout=0.1, epochs=epochs, lr=5e-3, batch_size=64, patience=100,
        warmup_epochs=2, scheduler="cosine", grad_clip=10.0,
        regression_type="multi-quantile", quantile_levels=[0.1, 0.5, 0.9],
        spatial_learnable=True, basis_unfreeze_epoch=1,
        packed_optimizer=False), **kw})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("shuffle,packed", [("auto", False), ("perm", True)])
def test_directory_resume_bitwise_equals_uninterrupted(tmp_path, shuffle,
                                                       packed):
    cfg = _cfg(10, shuffle=shuffle, packed_optimizer=packed)
    full = _fit(cfg, epochs_chunk=3)
    ckpt = tmp_path / "fit_ckpt"
    partial = _fit(cfg, epochs_chunk=3, checkpoint_path=ckpt,
                   session_epochs=6)
    assert partial.n_epochs_run == 6
    assert (ckpt / "state" / ".metadata").is_file()
    assert not (ckpt / "state.tmp").exists()
    assert not (ckpt / "state.old").exists()
    resumed = _fit(cfg, epochs_chunk=3, checkpoint_path=ckpt, resume=True)
    assert resumed.n_epochs_run == full.n_epochs_run == 10
    for k in ("train_loss", "val_loss", "val_rmse", "lr"):
        np.testing.assert_array_equal(resumed.history[k], full.history[k])
    for a, b in ((resumed.params, full.params),
                 (resumed.final_ema, full.final_ema)):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert resumed.n_steps == full.n_steps
    assert resumed.best_val == full.best_val


def test_directory_holds_the_npz_names(tmp_path):
    """The directory and the npz file hold the same names and values."""
    cfg = _cfg(2)
    _fit(cfg, checkpoint_path=tmp_path / "d")
    _fit(cfg, checkpoint_path=tmp_path / "f.npz")
    cd, ed, hd = tck.load_checkpoint(tmp_path / "d")
    cf, ef, hf = tck.load_checkpoint(tmp_path / "f.npz")
    assert ed == ef == 2
    gd, gf = cd.pop("generator_state"), cf.pop("generator_state")
    np.testing.assert_array_equal(gd, gf)
    fd, ff = _flat(cd), _flat(cf)
    assert fd.keys() == ff.keys()
    for k in fd:
        assert fd[k].dtype == ff[k].dtype, k
        np.testing.assert_array_equal(fd[k], ff[k], err_msg=k)
    assert hd[0].keys() == hf[0].keys()


def _tiny_carry(v: float):
    return {"params": {"w": np.full((3,), v, np.float32)},
            "step": np.asarray(int(v), np.int32),
            "generator_state": np.arange(4, dtype=np.uint8)}


def _val(carry) -> float:
    return float(carry["params"]["w"][0])


class TestCrashWindows:
    """The swap of `save_checkpoint` leaves a loadable state in every
    window (JAX tests/test_checkpoint.py:137-237)."""

    def _save(self, path, v, epochs):
        tck.save_checkpoint(path, _tiny_carry(v), epochs, [])

    def test_overwrite_swaps_cleanly(self, tmp_path):
        ckpt = tmp_path / "ck"
        self._save(ckpt, 1.0, 5)
        self._save(ckpt, 2.0, 10)
        assert (ckpt / "state").exists()
        assert not (ckpt / "state.tmp").exists()
        assert not (ckpt / "state.old").exists()
        carry, epochs, _ = tck.load_checkpoint(ckpt)
        assert _val(carry) == 2.0 and epochs == 10
        assert int(carry["step"]) == 2
        np.testing.assert_array_equal(carry["generator_state"],
                                      np.arange(4, dtype=np.uint8))
        assert tck.checkpoint_exists(ckpt)

    def _windows(self, tmp_path, first, second):
        a, b, ckpt = tmp_path / "a", tmp_path / "b", tmp_path / "ck"
        self._save(a, 1.0, 5)
        self._save(b, 2.0, 10)
        ckpt.mkdir()
        shutil.move(str(a / "state"), str(ckpt / first))
        shutil.move(str(b / "state"), str(ckpt / second))
        assert tck.checkpoint_exists(ckpt)
        carry, epochs, _ = tck.load_checkpoint(ckpt)
        return _val(carry), epochs

    def test_window_state_plus_tmp_prefers_completed(self, tmp_path):
        """A crash after writing state.tmp, before any rename: `state` is
        the last completed save."""
        assert self._windows(tmp_path, "state", "state.tmp") == (1.0, 5)

    def test_window_tmp_plus_old_prefers_tmp(self, tmp_path):
        """A crash between demoting the old state and promoting tmp: tmp
        is whole and newer."""
        assert self._windows(tmp_path, "state.old", "state.tmp") == (2.0, 10)

    def test_window_state_plus_old_prefers_state(self, tmp_path):
        """A crash after promoting tmp, before dropping the old copy."""
        assert self._windows(tmp_path, "state.old", "state") == (2.0, 10)

    def test_save_over_crash_residue_recovers(self, tmp_path):
        a, ckpt = tmp_path / "a", tmp_path / "ck"
        self._save(a, 1.0, 5)
        ckpt.mkdir()
        shutil.move(str(a / "state"), str(ckpt / "state.tmp"))
        self._save(ckpt, 3.0, 15)
        assert (ckpt / "state").exists()
        assert not (ckpt / "state.tmp").exists()
        assert not (ckpt / "state.old").exists()
        carry, epochs, _ = tck.load_checkpoint(ckpt)
        assert _val(carry) == 3.0 and epochs == 15

    def test_bare_checkpoint_dir_loads(self, tmp_path):
        """A path that is a checkpoint itself (<ckpt>/state) loads, so that
        checkpoint_exists() == True means load_checkpoint() succeeds."""
        a, ckpt = tmp_path / "a", tmp_path / "bare"
        self._save(a, 4.0, 7)
        shutil.move(str(a / "state"), str(ckpt))
        assert tck.checkpoint_exists(ckpt)
        carry, epochs, _ = tck.load_checkpoint(ckpt)
        assert _val(carry) == 4.0 and epochs == 7

    def test_empty_dir_raises_and_not_exists(self, tmp_path):
        ckpt = tmp_path / "ck"
        ckpt.mkdir()
        assert not tck.checkpoint_exists(ckpt)
        with pytest.raises(FileNotFoundError):
            tck.load_checkpoint(ckpt)
