"""KAUST competition CSV ingest (port of
`st_dadk_tpu/dataio/kaust.py::load_kaust_csv_single`).

Same contract: sites are the unique (x, y) pairs in order of first
appearance; t is 1-based in the file and 0-based in the dense (T, S)
matrix; files without a t column load as T = 1; optional z-score
normalisation with its statistics in the metadata. The file is read by the
native C++ ingest (`dataio/native.py`), which the JAX package tries first;
the numpy reader `read_kaust_csv` is only the plain version the tests hold
it to.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from st_dadk_tpu_torch.dataio.native import load_csv_native


def _read_columns(path: str | Path) -> Dict[str, np.ndarray]:
    with open(path, "r", encoding="utf-8") as f:
        header = [c.strip().strip('"') for c in f.readline().split(",")]
    data = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64,
                      ndmin=2)
    return {name: data[:, i] for i, name in enumerate(header)}


def read_kaust_csv(data_path: str | Path
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The numpy reader: (z (T, S) float32 with NaN where unobserved,
    coords (S, 2) float64 as parsed, rows), as `load_csv_native` returns
    them."""
    cols = _read_columns(data_path)
    pairs = np.stack([cols["x"], cols["y"]], axis=1)
    _, first, inverse = np.unique(pairs, axis=0, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first, kind="stable")       # first-appearance order
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    codes = rank[inverse.reshape(-1)]
    coords64 = pairs[first[order]]
    S = coords64.shape[0]

    if "t" in cols:
        T = int(cols["t"].max())
        t_idx = cols["t"].astype(np.int64) - 1
    else:
        T = 1
        t_idx = np.zeros(len(codes), dtype=np.int64)
    z_data = np.full((T, S), np.nan, dtype=np.float32)
    if "z" in cols:
        z_data[t_idx, codes] = cols["z"].astype(np.float32)
    return z_data, coords64, len(codes)


def load_kaust_csv_single(data_path: str | Path, normalize: bool = True,
                          verbose: bool = True
                          ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Load one CSV with columns (x, y, t, z) or (x, y, z).

    Returns z_data (T, S) float32 (NaN where unobserved), coords (S, 2)
    float32 and a metadata dict (S, T, z_mean, z_std)."""
    z_data, coords64, n_rows = load_csv_native(data_path)
    coords = coords64.astype(np.float32)
    T, S = z_data.shape
    if verbose:
        print(f"[INFO] Loaded data: {n_rows} rows, {S} sites, T={T} "
              "(native)")

    metadata: Dict = {"S": S, "T": T, "z_mean": 0.0, "z_std": 1.0}
    z_flat = z_data[~np.isnan(z_data)]
    if normalize and z_flat.size:
        z_mean = float(z_flat.mean())
        z_std = float(z_flat.std()) + 1e-8
        z_data = (z_data - z_mean) / z_std
        metadata["z_mean"], metadata["z_std"] = z_mean, z_std
    return z_data, coords, metadata
