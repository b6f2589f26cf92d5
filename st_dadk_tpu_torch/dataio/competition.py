"""A competition family cut from a full (x, y, t, z) field, in the layout of
the KAUST 2a family (`<fam>_<i>_train.csv`, `<fam>_<i>_test.csv`,
`<fam>-solutions.csv`), for the submission CLIs where the real family is
not in the checkout.

  - `<fam>_<i>_train.csv`: x, y, t, z for t = 1..T_train, with a seeded
    share of the rows of a seeded share of the sites dropped (so those
    sites have no complete history, as the forecaster's fallback expects);
  - `<fam>_<i>_test.csv`: x, y, t for t = T_train+1..T at every site, no z;
  - `<fam>-solutions.csv`: id and the true z of the test rows as `z<i>`.

Rows keep the field's order (t-major, the sites in file order).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from st_dadk_tpu_torch.dataio.kaust import _first_appearance, read_columns


def write_competition_family(field_csv: str | Path, out_dir: str | Path,
                             family: str = "2a", index: int = 8,
                             T_train: int = 90, site_share: float = 0.1,
                             row_share: float = 0.2,
                             seed: int = 0) -> Dict[str, Path]:
    """Write the three files into `out_dir`; returns their paths and the
    stem (`out_dir/<family>_<index>`) under 'stem'."""
    cols = read_columns(field_csv)
    x, y, t, z = cols["x"], cols["y"], cols["t"].astype(np.int64), cols["z"]
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    stem = out / f"{family}_{index}"

    rng = np.random.default_rng(seed)
    codes, sites = _first_appearance(x, y)
    in_gappy = (rng.random(len(sites)) < site_share)[codes]
    train = t <= T_train
    keep = train & ~(in_gappy & (rng.random(len(t)) < row_share))
    test = ~train

    def write(path: Path, header: str, rows: np.ndarray, fmt) -> None:
        np.savetxt(path, rows, delimiter=",", header=header, comments="",
                   fmt=fmt)

    paths = {"stem": stem,
             "train": Path(f"{stem}_train.csv"),
             "test": Path(f"{stem}_test.csv"),
             "solutions": out / f"{family}-solutions.csv"}
    write(paths["train"], "x,y,t,z",
          np.column_stack([x[keep], y[keep], t[keep], z[keep]]),
          ["%.6f", "%.6f", "%d", "%.6f"])
    write(paths["test"], "x,y,t", np.column_stack([x[test], y[test], t[test]]),
          ["%.6f", "%.6f", "%d"])
    write(paths["solutions"], f"id,z{index}",
          np.column_stack([np.arange(1, int(test.sum()) + 1), z[test]]),
          ["%d", "%.6f"])
    return paths
