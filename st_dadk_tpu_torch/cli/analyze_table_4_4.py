"""Table 4.4 analysis: scenario x model -> mean +- std test CRPS (port of
`scripts/analyze_table_4_4.py`, without pandas).

    python3 -m st_dadk_tpu_torch.cli.analyze_table_4_4 [RESULTS_DIR]

Reads `table_4_4_summary.json` (what `cli/run_table_4_4.py` writes) or, when
it is missing, walks `table4.4_<Scenario>_<Name>_<Model>/experiments/*/
results.json`; prints the table and writes `table_4_4_rendered.csv` into the
results directory (rows the scenarios, columns the models in order of first
appearance, a missing cell empty), as the JAX script's data frame writes it.
Without RESULTS_DIR it takes the last `results/*table_4_4*` directory.
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def load_table_4_4_results(results_dir: Path) -> Dict[str, Any]:
    """The summaries of a Table 4.4 run, from table_4_4_summary.json or the
    experiment directories."""
    summary_file = results_dir / "table_4_4_summary.json"
    if summary_file.exists():
        with open(summary_file, "r", encoding="utf-8") as f:
            return json.load(f)

    summaries: Dict[str, Any] = {}
    for cdir in sorted(results_dir.glob("table4.4_*")):
        parts = cdir.name.split("_")          # table4.4, Scenario, Name, Model
        model = parts[-1]
        scenario = "_".join(parts[1:-1])
        crps = []
        for rf in glob.glob(str(cdir / "experiments" / "*" / "results.json")):
            with open(rf, "r", encoding="utf-8") as f:
                r = json.load(f)
            if "test_crps" in r:
                crps.append(r["test_crps"])
        if crps:
            summaries[f"{scenario}/{model}"] = {
                "scenario": scenario, "model": model, "n": len(crps),
                "test_crps_mean": float(np.mean(crps)),
                "test_crps_std": float(np.std(crps)),
            }
    return summaries


def create_table_4_4(summaries: Dict[str, Any]
                     ) -> Tuple[List[str], List[str], Dict[str, Dict[str, str]]]:
    """(scenarios, models, cells[scenario][model] = 'mean ± std' or '-'):
    scenarios in order of first appearance, models in order of first
    appearance over the scenarios' rows (a data frame's column union)."""
    proto = summaries.get("_protocol", {})
    if isinstance(proto, dict) and proto.get("quarantined"):
        print("[WARNING] this run used the quarantined eq310 mode "
              "(reference sign-convention bug reproduction); CRPS values "
              "are noise, not model quality")
    cells: Dict[str, Dict[str, str]] = {}
    for entry in summaries.values():
        if not isinstance(entry, dict) or "scenario" not in entry:
            continue
        cells.setdefault(entry["scenario"], {})[entry["model"]] = (
            f"{entry['test_crps_mean']:.4f} ± {entry['test_crps_std']:.4f}"
            if entry["test_crps_mean"] is not None else "-")
    models: List[str] = []
    for row in cells.values():
        models += [m for m in row if m not in models]
    return list(cells), models, cells


def render(scenarios: List[str], models: List[str],
           cells: Dict[str, Dict[str, str]]) -> str:
    """The table as aligned text (NaN where a cell is missing)."""
    rows = [[""] + models] + [[s] + [cells[s].get(m, "NaN") for m in models]
                              for s in scenarios]
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return "\n".join("  ".join(c.rjust(w) if i else c.ljust(w)
                               for i, (c, w) in enumerate(zip(r, widths)))
                     for r in rows)


def write_table(scenarios: List[str], models: List[str],
                cells: Dict[str, Dict[str, str]], path: Path) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        wr = csv.writer(f)
        wr.writerow([""] + models)
        for s in scenarios:
            wr.writerow([s] + [cells[s].get(m, "") for m in models])


def main(argv: Optional[List[str]] = None) -> Path:
    parser = argparse.ArgumentParser()
    parser.add_argument("results_dir", type=str, nargs="?", default=None)
    args = parser.parse_args(argv)

    if args.results_dir is None:
        cands = sorted(glob.glob("results/*table_4_4*"))
        if not cands:
            raise SystemExit("no table_4_4 results directory found")
        args.results_dir = cands[-1]

    results_dir = Path(args.results_dir)
    summaries = load_table_4_4_results(results_dir)
    if not summaries:
        raise SystemExit(f"no results under {results_dir}")

    scenarios, models, cells = create_table_4_4(summaries)
    print("\nTable 4.4 — test CRPS (mean ± std)\n")
    print(render(scenarios, models, cells))
    out = results_dir / "table_4_4_rendered.csv"
    write_table(scenarios, models, cells, out)
    print(f"\nsaved -> {out}")
    return out


if __name__ == "__main__":
    main()
