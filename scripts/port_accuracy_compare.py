#!/usr/bin/env python
"""Compare N-seed accuracy runs of the JAX package and the PyTorch port
(`scripts/port_accuracy_jax.py`, `scripts/port_accuracy_torch.py`).

    python scripts/port_accuracy_compare.py NAME=RUN_DIR [NAME=RUN_DIR ...] \
        [--out results/port_accuracy/table.md]

Each RUN_DIR holds `summary/all_experiments.csv` (or `all_experiments.csv`
itself) and, where present, `run_info.json`. Prints a markdown table of
per-seed test CRPS and RMSE of every run, their means and stds, and the
delta of every later run's mean against the FIRST run's in units of the
first run's sigma of the mean (std / sqrt(n)), the rule of
`scripts/compare_evidence.py`: |delta| under about 0.6 sigma_mean is
indistinguishable from seed noise at 10 repeats. A second row gives the
same delta over sqrt(sigma_mean_ref^2 + sigma_mean_run^2), the spread of
a difference of two means, for reading only. Needs numpy only.
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import sys
from pathlib import Path

import numpy as np

METRICS = ("test_crps", "test_rmse")
NOISE_SIGMA = 0.6


def read_run(run_dir: Path):
    """({seed: {metric: value}}, run_info or {}) of one run directory."""
    path = run_dir / "summary" / "all_experiments.csv"
    if not path.exists():
        path = run_dir / "all_experiments.csv"
    with open(path, newline="", encoding="utf-8") as f:
        rows = {int(r["experiment_seed"]): {m: float(r[m]) for m in METRICS}
                for r in csv.DictReader(f)}
    info = {}
    if (run_dir / "run_info.json").exists():
        info = json.loads((run_dir / "run_info.json").read_text())
    return rows, info


def table(runs) -> str:
    """Markdown of the per-seed scores and the sigma_mean deltas; `runs` is
    [(name, rows, info)], the first being the reference."""
    names = [n for n, _, _ in runs]
    lines = []
    for name, rows, info in runs:
        where = info.get("hardware", "not recorded")
        wall = info.get("wall_seconds")
        lines.append(f"- `{name}`: {len(rows)} seeds, "
                     f"{info.get('framework', '?')} engine "
                     f"{info.get('engine', '?')} on {where}"
                     + (f", wall {wall:.1f} s" if wall is not None else ""))
    lines.append("")
    seeds = sorted(set().union(*[set(rows) for _, rows, _ in runs]))
    for metric in METRICS:
        lines.append(f"| seed | " + " | ".join(f"{n} {metric}" for n in names)
                     + " |")
        lines.append("|---|" + "---|" * len(names))
        for seed in seeds:
            cells = [repr(rows[seed][metric]) if seed in rows else "missing"
                     for _, rows, _ in runs]
            lines.append(f"| {seed} | " + " | ".join(cells) + " |")
        stats = []
        for _, rows, _ in runs:
            v = np.asarray([r[metric] for r in rows.values()], np.float64)
            stats.append((float(v.mean()), float(v.std()), v.size))
        lines.append("| mean | " + " | ".join(f"{m!r}" for m, _, _ in stats)
                     + " |")
        lines.append("| std | " + " | ".join(f"{s!r}" for _, s, _ in stats)
                     + " |")
        ref_mean, ref_std, ref_n = stats[0]
        sig = ref_std / math.sqrt(max(ref_n, 1))
        cells, both = ["reference"], ["reference"]
        for m, sd, n in stats[1:]:
            z = (m - ref_mean) / sig if sig > 0 else float("nan")
            verdict = "noise" if abs(z) < NOISE_SIGMA else "BEYOND NOISE"
            cells.append(f"{m - ref_mean:+.6f} = {z:+.2f} sigma_mean "
                         f"({verdict})")
            pooled = math.sqrt(ref_std ** 2 / max(ref_n, 1)
                               + sd ** 2 / max(n, 1))
            both.append(f"{(m - ref_mean) / pooled:+.2f}" if pooled > 0
                        else "nan")
        lines.append("| delta of means vs " + names[0] + " | "
                     + " | ".join(cells) + " |")
        lines.append("| the same delta over both runs' sigma_mean | "
                     + " | ".join(both) + " |")
        lines.append("")
    lines.append(f"sigma_mean = std / sqrt(n) of `{names[0]}`; |delta| under "
                 f"{NOISE_SIGMA} sigma_mean is seed noise "
                 f"(scripts/compare_evidence.py).")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="+", help="NAME=RUN_DIR, reference first")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    runs = []
    for item in args.runs:
        name, _, path = item.partition("=")
        rows, info = read_run(Path(path))
        runs.append((name, rows, info))
    text = table(runs)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
