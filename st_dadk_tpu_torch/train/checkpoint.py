"""Checkpoint files of the mid-training loop state (port of
`st_dadk_tpu/train/checkpoint.py`).

The JAX package chooses the format by path: an `.npz` file is its numpy
format, anything else an Orbax checkpoint directory. The port writes and
reads the npz format (`train/loop.py::save_fit_checkpoint`, the same
layout with the fit's generator state in place of the PRNG key); Orbax is
the JAX package's backend and a directory path raises NotImplementedError.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np


def is_orbax_path(path) -> bool:
    """Directory-like paths (no .npz suffix) select the Orbax backend."""
    return Path(path).suffix != ".npz"


def _refuse_orbax(path) -> None:
    if is_orbax_path(path):
        raise NotImplementedError(
            f"checkpoint path {str(path)!r} names an Orbax checkpoint "
            f"directory, the JAX package's backend; the port writes and "
            f"reads .npz checkpoint files")


def save_checkpoint(path, carry: Dict[str, Any], epochs_done: int,
                    hists: List[Dict[str, np.ndarray]]) -> None:
    _refuse_orbax(path)
    from st_dadk_tpu_torch.train.loop import save_fit_checkpoint
    save_fit_checkpoint(path, carry, epochs_done, hists)


def load_checkpoint(path) -> Tuple[Dict[str, Any], int, list]:
    _refuse_orbax(path)
    from st_dadk_tpu_torch.train.loop import load_fit_checkpoint
    return load_fit_checkpoint(path)


def checkpoint_exists(path) -> bool:
    _refuse_orbax(path)
    return Path(path).exists()
