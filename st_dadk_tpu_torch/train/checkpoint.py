"""Checkpoints of the mid-training loop state (port of
`st_dadk_tpu/train/checkpoint.py`).

Two formats behind one interface, chosen by path as in the JAX package:

  - `*.npz`: the numpy format (`train/loop.py::save_fit_checkpoint`, the
    JAX layout with the fit's generator state in place of the PRNG key);
  - any other path: a checkpoint directory written with
    `torch.distributed.checkpoint` (DCP). It holds the same flat names as
    the npz file (the carry's dotted leaves, `__generator_state`,
    `__epochs_done`, `__hist.<name>`), one tensor each.

Both resume bit for bit. The directory keeps the JAX backend's
crash-tolerant layout (`_orbax_state_dir`, `_save_orbax`): a save writes
`<dir>/state.tmp`, moves `state` to `state.old`, promotes `state.tmp` to
`state` and drops `state.old`, and a load takes `state`, else `state.tmp`
(fully written: it is promoted only after the write), else `state.old`, or
the directory itself where it is a checkpoint. DCP writes and reads in this
process only (`no_dist`): in a data-parallel fit the primary writes, and
every rank reads.

A directory that JAX's Orbax wrote is not readable by the port (Orbax's
format is not DCP's): a load of one raises ValueError with that reason.
"""
from __future__ import annotations

import contextlib
import shutil
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

STATE_NAMES = ("state", "state.tmp", "state.old")
# files that mark a checkpoint directory written by JAX's Orbax
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def is_orbax_path(path) -> bool:
    """Directory-like paths (no .npz suffix) select the directory backend
    (the JAX package's name for it, whose backend there is Orbax)."""
    return Path(path).suffix != ".npz"


def _is_dcp(p: Path) -> bool:
    return (p / ".metadata").is_file()


def _is_orbax(p: Path) -> bool:
    return any((p / m).exists() for m in ORBAX_MARKERS)


def _state_dir(p: Path) -> Optional[Path]:
    """The best state directory under `p` (module docstring), or `p` itself
    where it is a checkpoint; None where there is none."""
    for name in STATE_NAMES:
        if (p / name).exists():
            return p / name
    if _is_dcp(p) or _is_orbax(p):
        return p
    return None


@contextlib.contextmanager
def _quiet():
    """DCP warns that it saves in one process; that is the intent here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*single process.*")
        warnings.filterwarnings("ignore", category=FutureWarning,
                                module="torch.distributed.checkpoint")
        yield


def _flat_state(carry: Dict[str, Any], epochs_done: int,
                hists: List[Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    from st_dadk_tpu_torch.train.loop import _flatten_tree
    state = dict(carry)
    gen_state = state.pop("generator_state")
    flat = _flatten_tree(state)
    flat["__generator_state"] = np.asarray(gen_state, np.uint8)
    flat["__epochs_done"] = np.asarray(epochs_done, np.int64)
    for k in (hists[0] if hists else {}):
        flat[f"__hist.{k}"] = np.concatenate([h[k] for h in hists])
    return {k: torch.from_numpy(np.ascontiguousarray(v).copy())
            for k, v in flat.items()}


def _save_dir(path, carry: Dict[str, Any], epochs_done: int,
              hists: List[Dict[str, np.ndarray]]) -> None:
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    tmp, final, old = (path / n for n in ("state.tmp", "state", "state.old"))
    if tmp.exists():
        shutil.rmtree(tmp)
    import torch.distributed.checkpoint as dcp
    with _quiet():
        dcp.save(_flat_state(carry, epochs_done, hists),
                 checkpoint_id=str(tmp), no_dist=True)
    if old.exists():
        shutil.rmtree(old)
    if final.exists():
        final.rename(old)
    tmp.rename(final)
    if old.exists():
        shutil.rmtree(old)


def _load_dir(path) -> Tuple[Dict[str, Any], int, list]:
    import torch.distributed.checkpoint as dcp

    from st_dadk_tpu_torch.models.st_interp import lane_tree
    state_dir = _state_dir(Path(path).resolve())
    if state_dir is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    if not _is_dcp(state_dir):
        if _is_orbax(state_dir):
            raise ValueError(
                f"{state_dir} is a checkpoint written by JAX's Orbax; the "
                "port reads the directories it writes itself "
                "(torch.distributed.checkpoint), or .npz files, which both "
                "packages read")
        raise FileNotFoundError(f"no checkpoint in {state_dir}")
    meta = dcp.FileSystemReader(str(state_dir)).read_metadata()
    state = {k: torch.empty(m.size, dtype=m.properties.dtype)
             for k, m in meta.state_dict_metadata.items()}
    with _quiet():
        dcp.load(state, checkpoint_id=str(state_dir), no_dist=True)
    flat, hist, epochs_done, gen_state = {}, {}, 0, None
    for name, t in state.items():
        a = t.numpy()
        if name == "__generator_state":
            gen_state = a
        elif name == "__epochs_done":
            epochs_done = int(a)
        elif name.startswith("__hist."):
            hist[name[len("__hist."):]] = a
        else:
            flat[name] = a
    carry = lane_tree(flat)
    carry["generator_state"] = gen_state
    return carry, epochs_done, [hist] if hist else []


def save_checkpoint(path, carry: Dict[str, Any], epochs_done: int,
                    hists: List[Dict[str, np.ndarray]]) -> None:
    """Dispatch by path: .npz -> numpy file, else a DCP directory."""
    if is_orbax_path(path):
        _save_dir(path, carry, epochs_done, hists)
        return
    from st_dadk_tpu_torch.train.loop import save_fit_checkpoint
    save_fit_checkpoint(path, carry, epochs_done, hists)


def load_checkpoint(path) -> Tuple[Dict[str, Any], int, list]:
    if is_orbax_path(path):
        return _load_dir(path)
    from st_dadk_tpu_torch.train.loop import load_fit_checkpoint
    return load_fit_checkpoint(path)


def checkpoint_exists(path) -> bool:
    """Whether `path` holds a checkpoint to resume from. A JAX Orbax
    directory counts, so that a resume of one raises its reason in
    `load_checkpoint` instead of silently starting over."""
    p = Path(path)
    if is_orbax_path(path):
        return _state_dir(p) is not None
    return p.exists()
