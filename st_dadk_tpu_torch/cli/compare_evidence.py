"""Accuracy evidence of two runs side by side (port of the JAX package's
`scripts/compare_evidence.py`, which imports neither package).

    python3 -m st_dadk_tpu_torch.cli.compare_evidence table OLD NEW
    python3 -m st_dadk_tpu_torch.cli.compare_evidence families OLD NEW
    python3 -m st_dadk_tpu_torch.cli.compare_evidence grid OLD NEW

Renders markdown delta tables between two output directories of either
package:

  table mode:    two run_table_4_4 output dirs (table_4_4_summary.json)
  families mode: two score_families output dirs (scores.csv)
  grid mode:     two run_grid_search output dirs (grid_search_summary.csv)

Deltas are reported in units of the OLD run's per-cell std where available,
so "changed" vs "noise" is readable at a glance (10 repeats per cell; a
|delta| under ~0.6 sigma_mean is indistinguishable from seed noise). The
table mode skips a summary's run notes (keys beginning with '_', such as
'_protocol'), which the JAX script reads as a cell and fails on.
"""
from __future__ import annotations

import csv
import json
import math
import sys
from pathlib import Path
from typing import Optional, Sequence


def _cells(run_dir: Path) -> dict:
    """A table_4_4_summary.json's cells: its entries but the run's notes
    ('_protocol', '_output_dir'), which both packages write beside them."""
    summary = json.loads((run_dir / "table_4_4_summary.json").read_text())
    return {k: v for k, v in summary.items() if not k.startswith("_")}


def cmp_table(old_dir: Path, new_dir: Path) -> int:
    old, new = _cells(old_dir), _cells(new_dir)
    print(f"Table 4.4: {old_dir.name} -> {new_dir.name}\n")
    print("| scenario/model | old CRPS | new CRPS | delta | delta/sigma |")
    print("|---|---|---|---|---|")
    worst = 0.0
    for key in old:
        o, n = old[key], new.get(key)
        if n is None:
            print(f"| {key} | {o['test_crps_mean']:.4f} | MISSING | | |")
            continue
        d = n["test_crps_mean"] - o["test_crps_mean"]
        # sigma of the MEAN of n repeats
        sig = o["test_crps_std"] / math.sqrt(max(o.get("n", 10), 1))
        z = d / sig if sig > 0 else float("nan")
        worst = max(worst, abs(z))
        print(f"| {key} | {o['test_crps_mean']:.4f}±{o['test_crps_std']:.4f} "
              f"| {n['test_crps_mean']:.4f}±{n['test_crps_std']:.4f} "
              f"| {d:+.4f} | {z:+.2f} |")
    print(f"\nmax |delta| = {worst:.2f} sigma_mean across cells")
    return 0


def _read_scores(path: Path) -> dict:
    rows = {}
    with open(path / "scores.csv") as f:
        for row in csv.DictReader(f):
            key = row.get("dataset") or row.get("name") or row.get("family")
            if "field" in row and row["field"]:
                key = f"{key}.{row['field']}"
            rows[key] = row
    return rows


def cmp_families(old_dir: Path, new_dir: Path) -> int:
    old, new = _read_scores(old_dir), _read_scores(new_dir)
    cols = [c for c in ("rmse", "mae", "crps") if any(c in r for r in old.values())]
    print(f"Family scores: {old_dir.name} -> {new_dir.name}\n")
    print("| dataset | " + " | ".join(f"{c} old->new" for c in cols) + " |")
    print("|---|" + "---|" * len(cols))
    for key in old:
        n = new.get(key)
        cells = []
        for c in cols:
            ov = old[key].get(c, "")
            nv = n.get(c, "") if n else "MISSING"
            try:
                cells.append(f"{float(ov):.3f} -> {float(nv):.3f}")
            except (TypeError, ValueError):
                cells.append(f"{ov} -> {nv}")
        print(f"| {key} | " + " | ".join(cells) + " |")
    extra = sorted(set(new) - set(old))
    if extra:
        print(f"\nnew-only rows: {extra}")
    return 0


def cmp_grid(old_dir: Path, new_dir: Path) -> int:
    """Two run_grid_search output dirs (grid_search_summary.csv)."""
    def load(d: Path) -> dict:
        with open(d / "grid_search_summary.csv") as f:
            return {r["tag"]: r for r in csv.DictReader(f)}

    old, new = load(old_dir), load(new_dir)
    print(f"Grid summary: {old_dir.name} -> {new_dir.name}\n")
    print("| config | old CRPS | new CRPS | delta | delta/sigma "
          "| old RMSE | new RMSE |")
    print("|---|---|---|---|---|---|---|")
    worst = 0.0
    for tag in old:
        o, n = old[tag], new.get(tag)
        if n is None:
            print(f"| {tag} | {float(o['test_crps_mean']):.4f} "
                  f"| MISSING | | | | |")
            continue
        co, cn = float(o["test_crps_mean"]), float(n["test_crps_mean"])
        sig = (float(o["test_crps_std"])
               / math.sqrt(max(float(o["n_experiments"]), 1.0)))
        z = (cn - co) / sig if sig > 0 else float("nan")
        worst = max(worst, abs(z))
        print(f"| {tag} | {co:.4f}±{float(o['test_crps_std']):.4f} "
              f"| {cn:.4f}±{float(n['test_crps_std']):.4f} | {cn - co:+.4f} "
              f"| {z:+.2f} | {float(o['test_rmse_mean']):.4f} "
              f"| {float(n['test_rmse_mean']):.4f} |")
    print(f"\nmax |delta| = {worst:.2f} sigma_mean across configs")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    modes = {"table": cmp_table, "families": cmp_families, "grid": cmp_grid}
    if len(argv) != 3 or argv[0] not in modes:
        print(__doc__)
        return 2
    return modes[argv[0]](Path(argv[1]), Path(argv[2]))


if __name__ == "__main__":
    sys.exit(main())
