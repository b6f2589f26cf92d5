#!/usr/bin/env python
"""Full-length accuracy of the competition path, JAX package against the
PyTorch port, on a family in 2a's layout cut from the stand-in field
(`st_dadk_tpu_torch/dataio/competition.py`: train t = 1..90 with a seeded
share of rows dropped, test t = 91..100 at every site, the solutions).

    python3 scripts/port_accuracy_competition.py --side torch \
        --output_dir build/port_accuracy/competition_torch [--n 3]
    JAX_PLATFORMS=cpu python scripts/port_accuracy_competition.py \
        --side jax --output_dir build/port_accuracy/competition_jax [--n 3] \
        [--dropout_rng threefry] [--pipelines submission]
    python scripts/port_accuracy_competition.py \
        --compare jax=DIR torch=DIR --out results/port_accuracy/competition/table.md

Each side runs, for seeds 2025, 2026, ..., the submission pipeline on
configs/config_st_interp.yaml at full width and full length (500-epoch cap,
patience 50) and the forecast pipeline at ForecastSpec's defaults (batch
4096, 300 epochs, patience 20): the port's `st_dadk_tpu_torch.cli.
predict_submission` / `forecast_submission` in this process on the card,
JAX's `scripts/predict_submission.py` / `forecast_submission.py` as child
processes on the CPU. RMSE and MAE are computed here from each written
submission against the solutions column, at full precision, with the
persistence baseline (each site's last training value) beside them; the two
sides use their own init and RNG streams, so they agree in distribution,
not seed by seed. `scores.json` and `run_info.json` (the card's name and
power limit, or "CPU host") go into --output_dir. This script imports
neither jax nor pandas.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
FAMILY_DIR = REPO / "build" / "port_accuracy" / "competition_family"
PIPELINES = ("submission", "forecast")
NOISE_SIGMA = 0.6


def family():
    """The family's paths, written from the stand-in field on first use."""
    from st_dadk_tpu_torch.dataio.competition import write_competition_family
    from st_dadk_tpu_torch.dataio.synthetic import bench_data_file
    stem = FAMILY_DIR / "2a_8"
    paths = {"stem": stem, "train": Path(f"{stem}_train.csv"),
             "test": Path(f"{stem}_test.csv"),
             "solutions": FAMILY_DIR / "2a-solutions.csv"}
    if not all(p.exists() for k, p in paths.items() if k != "stem"):
        paths = write_competition_family(bench_data_file(), FAMILY_DIR)
    return paths


def scores(paths, submission: Path) -> dict:
    """RMSE / MAE of a submission against the solutions' z8, and the
    persistence baseline's RMSE / MAE."""
    from st_dadk_tpu_torch.dataio.kaust import load_kaust_csv, read_columns
    z_hat = read_columns(submission)["z"]
    y = read_columns(paths["solutions"])["z8"]
    z_train, _, _, site_to_idx, meta = load_kaust_csv(
        paths["train"], paths["test"], normalize=True, verbose=False)
    test = read_columns(paths["test"])
    site = np.array([site_to_idx[(float(a), float(b))]
                     for a, b in zip(test["x"], test["y"])])
    last = np.nan_to_num(z_train, nan=0.0)[-1] * meta["z_std"] + meta["z_mean"]
    pers = last[site]
    return {"rmse": float(np.sqrt(np.mean((z_hat - y) ** 2))),
            "mae": float(np.mean(np.abs(z_hat - y))),
            "persistence_rmse": float(np.sqrt(np.mean((pers - y) ** 2))),
            "persistence_mae": float(np.mean(np.abs(pers - y))),
            "finite": bool(np.all(np.isfinite(z_hat))), "rows": len(z_hat)}


def run_side(args) -> int:
    paths = family()
    out = args.output_dir
    out.mkdir(parents=True, exist_ok=True)
    config = REPO / "configs" / "config_st_interp.yaml"
    if args.dropout_rng:
        if args.side != "jax":
            raise SystemExit("--dropout_rng names a JAX dropout generator")
        # the repo's config with one key added, beside the scores
        text = config.read_text().rstrip("\n")
        config = out / "config.yaml"
        config.write_text(f"{text}\ndropout_rng: {args.dropout_rng}\n")
    config = str(config)
    card = "CPU host"
    if args.side == "torch":
        import torch
        if args.device == "cuda" and not torch.cuda.is_available():
            print("port_accuracy_competition: no CUDA device",
                  file=sys.stderr)
            return 2
        if args.device == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]
        from st_dadk_tpu_torch.cli import forecast_submission as fs
        from st_dadk_tpu_torch.cli import predict_submission as ps
    rows, t_all, wall_before = [], time.time(), 0.0
    if args.skip_existing and (out / "scores.json").exists():
        rows = json.loads((out / "scores.json").read_text())
        wall_before = json.loads(
            (out / "run_info.json").read_text())["wall_seconds"]
    done = {(r["pipeline"], r["seed"]) for r in rows}
    for i in range(args.n):
        seed = args.base_seed + i
        for pipe in args.pipelines:
            if (pipe, seed) in done:
                continue
            sub = out / f"{pipe}_{seed}.csv"
            argv = ["--family", str(paths["stem"]), "--seed", str(seed),
                    "--out", str(sub)]
            if pipe == "submission":
                argv += ["--config", config]
                if args.epochs:
                    argv += ["--epochs", str(args.epochs)]
            else:
                argv += ["--batch_size", "4096"]
                if args.forecast_epochs:
                    argv += ["--epochs", str(args.forecast_epochs)]
            t0 = time.time()
            if args.side == "torch":
                if args.device != "cuda":
                    argv += ["--device", args.device]
                summary = (ps if pipe == "submission" else fs).main(argv)
                epochs = (summary["n_epochs_run"] if pipe == "submission"
                          else summary["hist"]["n_epochs_run"])
            else:
                script = REPO / "scripts" / (
                    "predict_submission.py" if pipe == "submission"
                    else "forecast_submission.py")
                log = subprocess.run(
                    [sys.executable, str(script), *argv], cwd=REPO,
                    capture_output=True, text=True,
                    env=dict(os.environ, JAX_PLATFORMS="cpu"))
                (out / f"{pipe}_{seed}.log").write_text(log.stdout + log.stderr)
                if log.returncode != 0:
                    print(log.stderr[-2000:], file=sys.stderr)
                    return 1
                epochs = None
            row = {"pipeline": pipe, "seed": seed, "epochs_run": epochs,
                   "seconds": time.time() - t0, **scores(paths, sub)}
            rows.append(row)
            print(json.dumps(row), flush=True)
            (out / "scores.json").write_text(json.dumps(rows, indent=1))
    info = {"side": args.side, "n": args.n, "hardware": card,
            "pipelines": list(args.pipelines),
            "dropout_rng": args.dropout_rng or "config default",
            "wall_seconds": wall_before + time.time() - t_all,
            "family": str(paths["stem"].relative_to(REPO))}
    (out / "run_info.json").write_text(json.dumps(info, indent=1))
    print(f"wall {info['wall_seconds']:.1f} s on {card}", flush=True)
    return 0


def compare(runs, out_path) -> str:
    """A markdown table: per seed RMSE and MAE of each side and pipeline,
    their means and stds, and each later side's delta of means against the
    first side's in the first side's sigma_mean (std / sqrt(n))."""
    data = {}
    for spec in runs:
        name, d = spec.split("=", 1)
        data[name] = (json.loads((Path(d) / "scores.json").read_text()),
                      json.loads((Path(d) / "run_info.json").read_text()))
    lines = [f"- `{nm}`: {info.get('n', len(rows))} seeds on "
             f"{info['hardware']}"
             + (f", wall {info['wall_seconds']:.1f} s"
                if "wall_seconds" in info else "")
             for nm, (rows, info) in data.items()]
    for pipe in PIPELINES:
        # a run of scripts/port_accuracy_paired.py has submissions only
        per = {nm: {r["seed"]: r for r in rows
                    if r.get("pipeline", "submission") == pipe}
               for nm, (rows, _) in data.items()}
        names = [nm for nm in data if per[nm]]
        if not names:           # paired runs only: submissions, no forecast
            continue
        for m in ("rmse", "mae"):
            lines += ["", f"| {pipe} {m} by seed | "
                      + " | ".join(names) + " | persistence |",
                      "|---" * (len(names) + 2) + "|"]
            seeds = sorted(set.intersection(*(set(per[nm]) for nm in names)))
            for s in seeds:
                lines.append(f"| {s} | " + " | ".join(
                    f"{per[nm][s][m]!r}" for nm in names)
                    + f" | {per[names[0]][s]['persistence_' + m]!r} |")
            vals = {nm: np.array([per[nm][s][m] for s in seeds])
                    for nm in names}

            def sigma_mean(v):
                return float(v.std() / math.sqrt(len(v)))

            ref = vals[names[0]]
            lines.append("| mean | " + " | ".join(
                f"{float(vals[nm].mean())!r}" for nm in names) + " | |")
            lines.append("| std | " + " | ".join(
                f"{float(vals[nm].std())!r}" for nm in names) + " | |")
            deltas, pooled = [], []
            for nm in names[1:]:
                dlt = float(vals[nm].mean() - ref.mean())
                z = dlt / sigma_mean(ref)
                deltas.append(f"{dlt:+.6f} = {z:+.2f} sigma_mean "
                              + ("(noise)" if abs(z) < NOISE_SIGMA
                                 else "(BEYOND NOISE)"))
                pooled.append(f"{dlt / math.hypot(sigma_mean(ref), sigma_mean(vals[nm])):+.2f}")
            lines.append("| delta of means vs " + names[0] + " | reference | "
                         + " | ".join(deltas) + " | |")
            lines.append("| the same delta over both runs' sigma_mean | "
                         "reference | " + " | ".join(pooled) + " | |")
    lines += ["", f"sigma_mean = std / sqrt(n) of `{next(iter(data))}`; "
              f"|delta| under {NOISE_SIGMA} sigma_mean is seed noise "
              "(scripts/compare_evidence.py), the rule of the earlier "
              "tables; the second row puts both runs' spread in the "
              "denominator. Scores are in the field's units."]
    text = "\n".join(lines) + "\n"
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(text)
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", choices=["torch", "jax"])
    ap.add_argument("--output_dir", type=Path)
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--base_seed", type=int, default=2025)
    ap.add_argument("--epochs", type=int, default=None,
                    help="cut the submission fit's 500-epoch cap")
    ap.add_argument("--forecast_epochs", type=int, default=None,
                    help="cut the forecaster's 300 epochs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pipelines", nargs="+", choices=PIPELINES,
                    default=list(PIPELINES))
    ap.add_argument("--dropout_rng", choices=["rbg", "threefry"],
                    default=None,
                    help="JAX side: run on a copy of the config with this "
                    "dropout_rng (the config's default is rbg)")
    ap.add_argument("--skip_existing", action="store_true",
                    help="keep --output_dir's scores and run only the "
                    "seeds it lacks (wall seconds add up)")
    ap.add_argument("--compare", nargs="+", default=None,
                    help="NAME=DIR of each side's --output_dir")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.compare:
        print(compare(args.compare, args.out))
        return 0
    if not (args.side and args.output_dir):
        ap.error("--side and --output_dir, or --compare")
    return run_side(args)


if __name__ == "__main__":
    sys.exit(main())
