"""KAUST competition CSV ingest (port of `st_dadk_tpu/dataio/kaust.py`).

Same contract: sites are the unique (x, y) pairs in order of first
appearance; t is 1-based in the file and 0-based in the dense (T, S)
matrix; files without a t column load as T = 1; optional z-score
normalisation with its statistics in the metadata. A single file is read
by the native C++ ingest (`dataio/native.py`), which the JAX package tries
first; the numpy reader `read_kaust_csv` is only the plain version the
tests hold it to.

The competition layout is a train/test pair (`<stem>_train.csv` with z,
`<stem>_test.csv` with x, y, t and no z) over one combined site index:
`load_kaust_csv` reads both with the csv column reader (it needs each
row's t and sites, which the dense native loader does not return),
`predictions_to_csv` writes a submission with the standard library.
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from st_dadk_tpu_torch.dataio.native import load_csv_native


def read_columns(path: str | Path) -> Dict[str, np.ndarray]:
    """A CSV's columns as float64 by their stripped header names (quotes
    dropped); an empty or quoted-empty field reads as NaN, as pandas reads
    it."""
    with open(path, "r", newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = [c.strip().strip('"') for c in next(reader)]
        data = np.array([[float(v) if v.strip() else np.nan for v in row]
                         for row in reader if row], np.float64)
    return {name: data.reshape(-1, len(header))[:, i]
            for i, name in enumerate(header)}


def _first_appearance(x: np.ndarray, y: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(site code per row, the unique float64 (x, y) pairs (S, 2)), sites
    in order of first appearance."""
    pairs = np.stack([np.asarray(x, np.float64), np.asarray(y, np.float64)],
                     axis=1)
    _, first, inverse = np.unique(pairs, axis=0, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inverse.reshape(-1)], pairs[first[order]]


def _site_index(x: np.ndarray, y: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """(site code per row, coords (S, 2) float32, site_to_idx keyed by the
    exact float64 (x, y)), as JAX kaust.py:30-36 returns them."""
    codes, uniques = _first_appearance(x, y)
    site_to_idx = {(float(a), float(b)): i for i, (a, b) in enumerate(uniques)}
    return codes, uniques.astype(np.float32), site_to_idx


def read_kaust_csv(data_path: str | Path
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The numpy reader: (z (T, S) float32 with NaN where unobserved,
    coords (S, 2) float64 as parsed, rows), as `load_csv_native` returns
    them."""
    cols = read_columns(data_path)
    codes, coords64 = _first_appearance(cols["x"], cols["y"])
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


def load_kaust_csv(train_path: str | Path, test_path: str | Path,
                   normalize: bool = True, verbose: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Dict, Dict]:
    """A train/test pair over one site index (JAX kaust.py:115-178).

    Returns z_train (T_tr, S) float32 (NaN where unobserved, normalised
    with the train statistics), z_test (T_te, S) all NaN, coords (S, 2)
    float32, site_to_idx and metadata (z_mean, z_std, S, T_tr, T_te,
    T_te_start, coords, site_to_idx). Sites are the train rows' then the
    test rows' (x, y) in order of first appearance; a pair without a t
    column takes T_tr = T_te = T_te_start = 1."""
    tr = read_columns(train_path)
    te = read_columns(test_path)
    n_tr = len(tr["x"])
    if verbose:
        print(f"[INFO] Loaded train: {n_tr} rows")
        print(f"[INFO] Loaded test: {len(te['x'])} rows")
    codes_all, coords, site_to_idx = _site_index(
        np.concatenate([tr["x"], te["x"]]), np.concatenate([tr["y"], te["y"]]))
    S = coords.shape[0]
    codes_train = codes_all[:n_tr]
    if verbose:
        print(f"[INFO] Total sites: {S}")

    if "t" in tr:
        T_tr = int(tr["t"].max())
        T_te_start, T_te_end = int(te["t"].min()), int(te["t"].max())
        t_idx_train = tr["t"].astype(np.int64) - 1
        if verbose:
            print(f"[INFO] Train time range: 1 ~ {T_tr}")
            print(f"[INFO] Test time range: {T_te_start} ~ {T_te_end}")
    else:
        T_tr, T_te_start, T_te_end = 1, 1, 1
        t_idx_train = np.zeros(n_tr, dtype=np.int64)

    z_train = np.full((T_tr, S), np.nan, dtype=np.float32)
    if "z" in tr:
        z_train[t_idx_train, codes_train] = tr["z"].astype(np.float32)
    T_te = T_te_end - T_te_start + 1
    z_test = np.full((T_te, S), np.nan, dtype=np.float32)

    metadata: Dict = {}
    if normalize:
        valid = z_train[~np.isnan(z_train)]
        z_mean = float(valid.mean())
        z_std = float(valid.std() + 1e-8)
        z_train = (z_train - z_mean) / z_std
        metadata["z_mean"], metadata["z_std"] = z_mean, z_std
        if verbose:
            print(f"[INFO] Normalized: mean={z_mean:.4f}, std={z_std:.4f}")
    else:
        metadata["z_mean"], metadata["z_std"] = 0.0, 1.0
    metadata.update({"S": S, "T_tr": T_tr, "T_te": T_te,
                     "T_te_start": T_te_start, "coords": coords,
                     "site_to_idx": site_to_idx})
    return z_train, z_test, coords, site_to_idx, metadata


def sample_observed_sites(coords: np.ndarray, obs_fraction: float,
                          sampling_method: str = "uniform",
                          bias_sigma: float = 0.15, bias_temp: float = 1.0,
                          seed: Optional[int] = None) -> np.ndarray:
    """Uniform or origin-biased site subset, sorted (JAX kaust.py:181-204:
    numpy's global stream, seeded with `seed` when given)."""
    if seed is not None:
        np.random.seed(seed)
    S = len(coords)
    n_obs = max(1, int(S * obs_fraction))
    if sampling_method == "uniform":
        obs_indices = np.random.choice(S, size=n_obs, replace=False)
    elif sampling_method == "biased":
        distances = np.sqrt(coords[:, 0] ** 2 + coords[:, 1] ** 2)
        weights = np.exp(-(distances ** 2) / (2 * bias_sigma ** 2))
        weights = weights ** (1.0 / bias_temp)
        probs = weights / weights.sum()
        obs_indices = np.random.choice(S, size=n_obs, replace=False, p=probs)
    else:
        raise ValueError(f"Unknown sampling method: {sampling_method}")
    return np.sort(obs_indices)


def write_z_csv(z: np.ndarray, path: str | Path) -> None:
    """One column `z`, a value a row in its shortest round-trip form and
    NaN as a quoted empty field, as pandas' `to_csv(index=False)` writes a
    one-column frame."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("z\n")
        f.writelines(('""' if v != v else repr(float(v))) + "\n"
                     for v in np.asarray(z, np.float64))


def predictions_to_csv(y_pred: np.ndarray, test_csv_path: str | Path,
                       output_path: str | Path, site_to_idx: Dict,
                       z_mean: float, z_std: float,
                       denormalize: bool = True) -> None:
    """Competition submission writer (JAX kaust.py:207-230): the test
    rows' (t, site) cells of y_pred (T_te, S), NaN past its horizon."""
    te = read_columns(test_csv_path)
    if denormalize:
        y_pred = y_pred * z_std + z_mean
    n = len(te["x"])
    t = te["t"].astype(np.int64) if "t" in te else np.ones(n, np.int64)
    t_rel = t - t.min()
    site_idx = np.array([site_to_idx[(float(a), float(b))]
                         for a, b in zip(te["x"], te["y"])], dtype=np.int64)
    z_hat = np.full(n, np.nan, dtype=np.float64)
    in_range = t_rel < len(y_pred)
    z_hat[in_range] = y_pred[t_rel[in_range], site_idx[in_range]]
    write_z_csv(z_hat, output_path)
    print(f"[INFO] Saved predictions to {output_path}")
