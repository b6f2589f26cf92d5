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

    python scripts/port_accuracy_compare.py --table44 NAME=TREE NAME=TREE \
        [--out results/port_accuracy/table_4_4/table.md]

Table 4.4 instead: each TREE is the output of `scripts/run_table_4_4.py` or
`python3 -m st_dadk_tpu_torch.cli.run_table_4_4`, one directory a
(scenario, model) cell with its `summary/all_experiments.csv`. For each
cell: test CRPS mean and std of every run, and every later run's delta
against the first run's mean in the first run's sigma_mean; |delta| beyond
`FAR_SIGMA` is named. For each scenario: whether DA-STDK's mean CRPS is
below STDK's, on every side.

    python scripts/port_accuracy_compare.py --collect TREE DEST

copies a Table 4.4 tree's summaries (`table_4_4_summary.json`,
`run_info.json`, and each cell's `config.yaml`, `scenario_summary.json`
and `summary/*.{json,csv}`) to DEST, without the per-experiment
directories.
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
FAR_SIGMA = 2.0
SCENARIOS = ("Fixed_Uniform", "Fixed_Clustered", "Random_Uniform",
             "Random_Clustered")
MODELS = ("STDK", "DA-STDK")


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


def _cell_dir(tree: Path, scenario: str, model: str) -> Path:
    return tree / f"table4.4_{scenario}_{model}"


def read_table44(tree: Path):
    """({(scenario, model): {seed: test CRPS}}, run_info or {})."""
    cells = {}
    for scenario in SCENARIOS:
        for model in MODELS:
            path = _cell_dir(tree, scenario, model) / "summary" / \
                "all_experiments.csv"
            with open(path, newline="", encoding="utf-8") as f:
                cells[(scenario, model)] = {
                    int(r["experiment_seed"]): float(r["test_crps"])
                    for r in csv.DictReader(f)}
    info = {}
    if (tree / "run_info.json").exists():
        info = json.loads((tree / "run_info.json").read_text())
    return cells, info


def table44(runs) -> str:
    """Markdown of Table 4.4 on every side and the per-cell deltas against
    the first; `runs` is [(name, cells, info)]."""
    names = [n for n, _, _ in runs]
    lines = []
    for name, cells, info in runs:
        wall = info.get("wall_seconds")
        lines.append(f"- `{name}`: {info.get('framework', '?')} engine "
                     f"{info.get('engine', '?')} on "
                     f"{info.get('hardware', 'not recorded')}"
                     + (f", wall {wall:.1f} s" if wall is not None else "")
                     + ", seeds " + ", ".join(str(n) for n in sorted(
                         {len(v) for v in cells.values()})) + " a cell")
    lines.append("")
    lines.append("| scenario | model | " + " | ".join(
        f"{n} test CRPS mean +- std" for n in names) + " | " + " | ".join(
        f"{n} - {names[0]}" for n in names[1:]) + " |")
    lines.append("|---|---|" + "---|" * (2 * len(names) - 1))
    far = []
    for scenario in SCENARIOS:
        for model in MODELS:
            stats = []
            for _, cells, _ in runs:
                v = np.asarray(list(cells[(scenario, model)].values()),
                               np.float64)
                stats.append((float(v.mean()), float(v.std()), v.size))
            ref_mean, ref_std, ref_n = stats[0]
            sig = ref_std / math.sqrt(max(ref_n, 1))
            deltas = []
            for name, (m, _, _) in zip(names[1:], stats[1:]):
                z = (m - ref_mean) / sig if sig > 0 else float("nan")
                deltas.append(f"{m - ref_mean:+.6f} = {z:+.2f} sigma_mean")
                if not abs(z) <= FAR_SIGMA:
                    far.append(f"{scenario} / {model}: `{name}` {z:+.2f} "
                               f"sigma_mean")
            lines.append(f"| {scenario} | {model} | " + " | ".join(
                f"{m:.6f} +- {sd:.6f} (n={n})" for m, sd, n in stats)
                + " | " + " | ".join(deltas) + " |")
    lines.append("")
    lines.append("DA-STDK's mean test CRPS below STDK's:")
    lines.append("")
    lines.append("| scenario | " + " | ".join(names) + " |")
    lines.append("|---|" + "---|" * len(names))
    for scenario in SCENARIOS:
        cells_ = []
        for _, cells, _ in runs:
            st, da = (float(np.mean(list(cells[(scenario, m)].values())))
                      for m in MODELS)
            cells_.append(f"{'yes' if da < st else 'no'} ({da - st:+.6f})")
        lines.append(f"| {scenario} | " + " | ".join(cells_) + " |")
    lines.append("")
    lines.append(f"sigma_mean = std / sqrt(n) of `{names[0]}`'s cell; "
                 f"|delta| beyond {FAR_SIGMA} sigma_mean: "
                 + ("; ".join(far) if far else "none") + ".")
    return "\n".join(lines)


def collect(tree: Path, dest: Path) -> None:
    """Copy a Table 4.4 tree's summaries (module docstring) to `dest`."""
    import shutil
    files = [tree / "table_4_4_summary.json", tree / "run_info.json"]
    for scenario in SCENARIOS:
        for model in MODELS:
            cell = _cell_dir(tree, scenario, model)
            files += [cell / "config.yaml", cell / "scenario_summary.json"]
            files += sorted((cell / "summary").glob("*.json"))
            files += sorted((cell / "summary").glob("*.csv"))
    for f in files:
        if f.exists():
            out = dest / f.relative_to(tree)
            out.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(f, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="*", help="NAME=RUN_DIR, reference first")
    ap.add_argument("--table44", action="store_true",
                    help="the runs are Table 4.4 trees")
    ap.add_argument("--collect", nargs=2, type=Path, metavar=("TREE", "DEST"))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.collect:
        collect(*args.collect)
        return 0
    runs = []
    for item in args.runs:
        name, _, path = item.partition("=")
        runs.append((name, *(read_table44 if args.table44 else read_run)(
            Path(path))))
    text = (table44 if args.table44 else table)(runs)
    print(text)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
