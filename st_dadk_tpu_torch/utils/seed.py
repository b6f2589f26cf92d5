"""Seeding (port of `st_dadk_tpu/utils/seed.py`).

`set_seed` seeds Python's and numpy's global generators and torch's, and
returns a `torch.Generator` seeded alike for a caller's own draws, where
the JAX package returns the run's root PRNG key. The fit itself draws
from private streams (`np.random.RandomState` for masks and subsamples, a
`torch.Generator` for shuffles and dropout), so no lock guards the global
numpy stream as the JAX package's `GLOBAL_NP_RNG_LOCK` does.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int, device: torch.device | str = "cpu"
             ) -> torch.Generator:
    """Seed Python, numpy and torch; a generator on `device` seeded with
    `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(int(seed))
