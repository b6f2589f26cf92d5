"""Grid-search analysis (port of `scripts/analyze_grid_search.py`, without
pandas).

    python3 -m st_dadk_tpu_torch.cli.analyze_grid_search [RESULTS_DIR]

Regenerates each config's summary from its `results.json` files, rewrites
the grid-level CSVs (`sweep.grid.save_experiment_results`), labels each
config by the parameters that vary across the grid, writes
`detailed_summary.csv` (mean and sample std of test RMSE and CRPS a method
label and data file, sorted by both) and prints the best method a metric.
The boxplot figures need matplotlib, imported inside the plotting
functions: where it is missing the run warns and still writes every CSV.
Without RESULTS_DIR it takes the last `results/*grid_search*` directory.
"""
from __future__ import annotations

import argparse
import glob
import math
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from st_dadk_tpu_torch.config import read_yaml
from st_dadk_tpu_torch.sweep.grid import save_experiment_results, write_records
from st_dadk_tpu_torch.train.runner import aggregate_results, load_all_results

CANDIDATE_PARAMS = ["data_file", "spatial_basis_function",
                    "spatial_init_method", "spatial_learnable",
                    "obs_method", "obs_ratio", "obs_spatial_pattern"]
ABBREV = {"spatial_init_method": {"uniform": "uni", "gmm": "gmm",
                                  "random_site": "rnd",
                                  "kmeans_balanced": "kmb", "kmeans_exact": "kme"},
          "spatial_basis_function": {"wendland": "wend", "gaussian": "gaus",
                                     "triangular": "tria"}}
PLOT_METRICS = ("test_rmse", "test_crps", "test_check_loss")
SUMMARY_METRICS = ("test_rmse", "test_crps")


def regenerate_config_summaries(results_dir: Path) -> List[Dict[str, Any]]:
    """Walk every config dir, recompute its summary from its results.json
    files; a config without `config_id` takes its position (1-based)."""
    all_results = []
    for cfg_file in sorted(results_dir.glob("**/config.yaml")):
        cdir = cfg_file.parent
        config = read_yaml(cfg_file)
        results = load_all_results(cdir / "experiments",
                                   config.get("n_experiments", 10))
        summary = (aggregate_results(results, cdir / "summary")
                   if results else None)
        if "config_id" not in config:
            config["config_id"] = len(all_results) + 1
        all_results.append({"config": config, "summary": summary,
                            "status": "success" if summary else "empty"})
    return all_results


def identify_varying_parameters(configs: List[Dict[str, Any]]) -> List[str]:
    return [p for p in CANDIDATE_PARAMS
            if len({str(c.get(p)) for c in configs}) > 1]


def create_method_label(config: Dict[str, Any], varying: List[str]) -> str:
    parts = []
    for p in varying:
        if p == "data_file":
            continue
        v = config.get(p)
        if p in ABBREV:
            parts.append(ABBREV[p].get(v, str(v)))
        elif p == "spatial_learnable":
            parts.append("lrn" if v else "fix")
        else:
            parts.append(str(v))
    return "_".join(parts) or config.get("tag", "config")


def _missing(v: Any) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _finite(rows: List[Dict[str, Any]], metric: str) -> np.ndarray:
    return np.asarray([r[metric] for r in rows
                       if not _missing(r.get(metric))], np.float64)


def _has_metric(rows: List[Dict[str, Any]], metric: str) -> bool:
    return any(not _missing(r.get(metric)) for r in rows)


def _groups(rows: List[Dict[str, Any]], *keys: str
            ) -> Dict[tuple, List[Dict[str, Any]]]:
    """Rows grouped by `keys`, sorted by them; rows with a missing key left
    out (a data frame's groupby)."""
    out: Dict[tuple, List[Dict[str, Any]]] = {}
    for r in rows:
        key = tuple(r.get(k) for k in keys)
        if not any(_missing(v) for v in key):
            out.setdefault(key, []).append(r)
    return dict(sorted(out.items()))


def detailed_summary(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """A record a (method label, data file): the mean and the sample
    standard deviation (ddof 1, NaN for one value) of each metric present,
    over its finite values."""
    present = [m for m in SUMMARY_METRICS if _has_metric(rows, m)]
    records = []
    for (label, dfile), g in _groups(rows, "method_label",
                                     "data_file").items():
        rec: Dict[str, Any] = {"method": label, "data_file": dfile}
        for m in present:
            v = _finite(g, m)
            rec[f"{m}_mean"] = float(v.mean()) if v.size else math.nan
            rec[f"{m}_std"] = float(v.std(ddof=1)) if v.size > 1 else math.nan
        records.append(rec)
    return records


def plot_boxplots(rows: List[Dict[str, Any]], results_dir: Path,
                  metric: str = "test_rmse") -> None:
    """Per-data-file boxplots of the metric by method label."""
    if not any(metric in r for r in rows):
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    by_file = _groups(rows, "data_file")
    fig, axes = plt.subplots(1, len(by_file), squeeze=False,
                             figsize=(max(6, 4 * len(by_file)), 5))
    for ax, ((dfile,), sub) in zip(axes[0], by_file.items()):
        groups = _groups(sub, "method_label")
        labels = [k[0] for k in groups]
        vals = [_finite(g, metric) for g in groups.values()]
        if not vals:
            continue
        ax.boxplot(vals, labels=labels)
        ax.set_title(Path(str(dfile)).stem)
        ax.set_ylabel(metric)
        ax.tick_params(axis="x", rotation=45)
        ax.grid(alpha=0.3)
    fig.suptitle(f"{metric} by method")
    fig.tight_layout()
    fig.savefig(results_dir / f"boxplot_{metric}.png", dpi=110)
    plt.close(fig)


def plot_matrix_boxplots(rows: List[Dict[str, Any]], results_dir: Path,
                         metric: str = "test_rmse") -> None:
    """One figure a data file: subplot rows the obs spatial patterns,
    columns the (obs_method, ratio) pairs, boxes the method labels in
    stable colors."""
    if not _has_metric(rows, metric):
        return
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    methods = sorted({r["method_label"] for r in rows})
    palette = plt.cm.Set2(np.linspace(0, 1, max(len(methods), 3)))
    colors_of = {m: palette[i % len(palette)] for i, m in enumerate(methods)}

    for (dfile,), dff in _groups(rows, "data_file").items():
        def levels(col):
            return sorted({r[col] for r in dff if not _missing(r.get(col))})
        patterns, ratios = levels("obs_spatial_pattern"), levels("obs_ratio")
        obs_methods = levels("obs_method")
        if not patterns or not ratios or not obs_methods:
            continue
        col_cfgs = [(m, r) for m in obs_methods for r in ratios]
        fig, axes = plt.subplots(len(patterns), len(col_cfgs), squeeze=False,
                                 figsize=(6 * len(col_cfgs),
                                          5 * len(patterns)))
        fig.suptitle(f"Performance Comparison: {dfile}",
                     fontsize=16, fontweight="bold", y=0.995)
        for ri, pattern in enumerate(patterns):
            for ci, (om, orat) in enumerate(col_cfgs):
                ax = axes[ri, ci]
                sub = [r for r in dff if r.get("obs_spatial_pattern") == pattern
                       and r.get("obs_method") == om
                       and r.get("obs_ratio") == orat]
                title = f"{str(pattern).capitalize()} | {om}, r={orat}"
                data, labels, colors = [], [], []
                for m in methods:
                    vals = _finite([r for r in sub
                                    if r["method_label"] == m], metric)
                    if len(vals):
                        data.append(vals)
                        labels.append(m)
                        colors.append(colors_of[m])
                if not data:
                    ax.text(0.5, 0.5, "No data", ha="center", va="center",
                            transform=ax.transAxes, fontsize=14)
                    ax.set_title(title, fontsize=11, fontweight="bold")
                    continue
                positions = np.arange(len(data))
                bp = ax.boxplot(data, positions=positions, widths=0.6,
                                patch_artist=True,
                                medianprops=dict(color="black", linewidth=2),
                                whiskerprops=dict(linewidth=1.5),
                                capprops=dict(linewidth=1.5),
                                flierprops=dict(marker="o", markersize=5,
                                                alpha=0.5))
                for patch, color in zip(bp["boxes"], colors):
                    patch.set_facecolor(color)
                    patch.set_alpha(0.7)
                ax.set_xticks(positions)
                ax.set_xticklabels(labels, rotation=45, ha="right",
                                   fontsize=10)
                ax.set_ylabel(metric, fontsize=10, fontweight="bold")
                ax.set_title(title, fontsize=11, fontweight="bold")
                ax.grid(True, alpha=0.3, axis="y", linestyle="--")
                ax.margins(x=0.1)
        fig.tight_layout()
        fname = (str(dfile).replace("/", "_").replace(".csv", "")
                 + f"_{metric}.png")
        fig.savefig(results_dir / fname, dpi=150, bbox_inches="tight")
        plt.close(fig)


def plot_by_parameter(rows: List[Dict[str, Any]], results_dir: Path,
                      varying: List[str]) -> None:
    """For each varying parameter, the test RMSE and CRPS pooled over
    everything else."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    for p in varying:
        if p == "data_file" or not any(p in r for r in rows):
            continue
        for metric in SUMMARY_METRICS:
            if not _has_metric(rows, metric):
                continue
            groups = _groups(rows, p)
            fig, ax = plt.subplots(figsize=(6, 4.5))
            ax.boxplot([_finite(g, metric) for g in groups.values()],
                       labels=[str(k[0]) for k in groups])
            ax.set_title(f"{metric} aggregated by {p}")
            ax.grid(alpha=0.3)
            fig.tight_layout()
            fig.savefig(results_dir / f"boxplot_{metric}_by_{p}.png", dpi=110)
            plt.close(fig)


def analyze(results_dir: Path) -> List[Dict[str, Any]]:
    """The whole analysis of one results tree; returns the detailed
    summary's records."""
    print(f"[1/3] regenerating per-config summaries in {results_dir}")
    all_results = regenerate_config_summaries(results_dir)
    ok = [r for r in all_results if r["summary"] is not None]
    if not ok:
        raise SystemExit("no completed configs found")

    print("[2/3] regenerating grid-level CSVs")
    _, rows = save_experiment_results(all_results, results_dir)

    print("[3/3] plots + insights")
    configs = [r["config"] for r in ok]
    varying = identify_varying_parameters(configs)
    id_to_config = {c["config_id"]: c for c in configs}
    for r in rows:
        cfg = id_to_config.get(r["config_id"], {})
        r["method_label"] = create_method_label(cfg, varying)
        for col in ("data_file", "obs_spatial_pattern", "obs_method",
                    "obs_ratio"):
            r.setdefault(col, cfg.get(col))

    try:
        for metric in PLOT_METRICS:
            plot_boxplots(rows, results_dir, metric)
            plot_matrix_boxplots(rows, results_dir, metric)
        plot_by_parameter(rows, results_dir, varying)
    except ImportError as e:
        print(f"[WARNING] no figures: {e}")

    detailed = detailed_summary(rows)
    write_records(detailed, results_dir / "detailed_summary.csv")
    for m in SUMMARY_METRICS:
        ranked = [d for d in detailed if f"{m}_mean" in d
                  and not math.isnan(d[f"{m}_mean"])]
        if ranked:
            best = min(ranked, key=lambda d: d[f"{m}_mean"])
            print(f"  best {m}: {best['method']} on {best['data_file']} "
                  f"({best[f'{m}_mean']:.4f})")
    print(f"analysis artifacts -> {results_dir}")
    return detailed


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    parser = argparse.ArgumentParser()
    parser.add_argument("results_dir", type=str, nargs="?", default=None)
    args = parser.parse_args(argv)
    if args.results_dir is None:
        cands = sorted(glob.glob("results/*grid_search*"))
        if not cands:
            raise SystemExit("no grid_search results directory found")
        args.results_dir = cands[-1]
    return analyze(Path(args.results_dir))


if __name__ == "__main__":
    main()
