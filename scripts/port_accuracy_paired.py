#!/usr/bin/env python
"""Paired full-length competition submissions, JAX package against the
PyTorch port: both fits start from JAX's spatial centers and initial
parameters, draw JAX's shuffle (the hash multipliers of every epoch) and
run without dropout, so the two differ only in their arithmetic.

    JAX_PLATFORMS=cpu python scripts/port_accuracy_paired.py --side jax \
        --output_dir build/port_accuracy/paired_jax [--seeds 2025 2026]
    python3 scripts/port_accuracy_paired.py --side torch \
        --init_dir build/port_accuracy/paired_jax \
        --output_dir build/port_accuracy/paired_torch [--ulp]
    python scripts/port_accuracy_paired.py --compare \
        jax=build/port_accuracy/paired_jax torch=DIR [torch_ulp=DIR] \
        [--out results/port_accuracy/competition/paired.md]

The JAX side runs `scripts/predict_submission.py`'s `main` in this process
(on the CPU) on configs/config_st_interp.yaml with `dropout: 0.0`, and
writes, a seed each, `init_<seed>.npz` (its centers, bandwidths, initial
params and consts, and the multipliers of every epoch at the fit's
capacity), its submission and its per-epoch history. The torch side (the
card unless `--device cpu`) runs the port's `cli/predict_submission.py`
`main` on the same family and config with those handed across; `--ulp`
moves every initial parameter by one float32 ulp first, which measures how
far the fit's own chaos carries a rounding difference in 500 epochs (the
floor for a JAX/port gap). Unpaired in part: `--side jax --init_only
[--cap N]` writes the inits (and the multipliers at capacity N) without a
fit and with the config's dropout, and `--side torch --keep_dropout
[--own_shuffle]` keeps the config's dropout (the port's own mask stream)
and, with `--own_shuffle`, the port's own multipliers.
`--compare` prints a markdown table: RMSE / MAE
a seed and side, and for each side against the first the per-epoch
validation loss gap (the first epoch past 1e-4, 1e-3 and 1e-2 relative).
The torch side imports the port and not JAX; the JAX side imports the JAX
package, and both score a submission with
`scripts/port_accuracy_competition.py::scores` (numpy, on the family that
script cuts from the stand-in field).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
FAMILY_STEM = REPO / "build" / "port_accuracy" / "competition_family" / "2a_8"
CONFIG = REPO / "configs" / "config_st_interp.yaml"
GAPS = (1e-4, 1e-3, 1e-2)


def paired_config(config: Path, out_dir: Path, epochs=None) -> Path:
    """`config` with dropout 0 (and `epochs`)."""
    lines = []
    for line in config.read_text().splitlines():
        key = line.split(":", 1)[0].strip()
        if key == "dropout":
            line = "dropout: 0.0"
        elif key == "epochs" and epochs:
            line = f"epochs: {epochs}"
        lines.append(line)
    path = out_dir / "config_paired.yaml"
    path.write_text("\n".join(lines) + "\n")
    return path


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nest(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _history(hist) -> dict:
    return {k: [float(x) for x in np.asarray(v)] for k, v in hist.items()
            if k in ("train_loss", "val_loss")}


def run_jax(args) -> int:
    import importlib.util

    from st_dadk_tpu.train import loop as jloop

    spec = importlib.util.spec_from_file_location(
        "_predict_submission", REPO / "scripts" / "predict_submission.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = args.output_dir
    out.mkdir(parents=True, exist_ok=True)
    config = paired_config(args.config, out, args.epochs)
    n_epochs = next(int(line.split(":")[1]) for line in
                    config.read_text().splitlines()
                    if line.startswith("epochs:"))
    if args.init_only:
        return jax_init_only(args, script)
    caps = []          # a jitted epoch traces once: the first fit's capacity
    for seed in args.seeds:
        seen = {}
        init_model, fit = script.init_model, script.fit
        batch_indices = jloop.epoch_batch_indices

        def init_capture(key, spec_, centers, bw):
            params, consts = init_model(key, spec_, centers, bw)
            seen["init"] = (centers, bw, params, consts)
            return params, consts

        def fit_capture(*a, **kw):
            seen["result"] = fit(*a, **kw)
            return seen["result"]

        def indices_capture(perm_key, cap, *a, **kw):
            caps.append(int(cap))
            return batch_indices(perm_key, cap, *a, **kw)

        script.init_model, script.fit = init_capture, fit_capture
        jloop.epoch_batch_indices = indices_capture
        sub = out / f"submission_{seed}.csv"
        argv = sys.argv
        sys.argv = ["predict_submission.py", "--family", str(FAMILY_STEM),
                    "--config", str(config), "--seed", str(seed),
                    "--out", str(sub)]
        t0 = time.time()
        try:
            script.main()
        finally:
            sys.argv = argv
            script.init_model, script.fit = init_model, fit
            jloop.epoch_batch_indices = batch_indices
        seconds = time.time() - t0
        cap, result = caps[0], seen["result"]
        mult = jax_multipliers(seed, cap, n_epochs)
        centers, bw, params, consts = seen["init"]
        np.savez(out / f"init_{seed}.npz", centers=np.asarray(centers),
                 bw=np.asarray(bw), cap=cap, multipliers=mult,
                 **{f"params/{k}": v for k, v in _flat(params).items()},
                 **{f"consts/{k}": v for k, v in _flat(consts).items()})
        write_row(out, seed, sub, _history(result.history),
                  result.n_epochs_run, seconds)
    return 0


def jax_multipliers(seed: int, cap: int, n_epochs: int) -> np.ndarray:
    """(n_epochs, 4) int32: the hash multipliers JAX's fit of `seed` draws
    each epoch at capacity `cap` (st_dadk_tpu/train/loop.py:433-475)."""
    import jax
    import jax.numpy as jnp

    width = cap if cap & (cap - 1) == 0 else 1 << cap.bit_length()
    root = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.randint(
        jax.random.split(jax.random.fold_in(root, e))[0], (4,), 0, width,
        dtype=jnp.int32)) for e in range(n_epochs)])


def jax_init_only(args, script) -> int:
    """JAX's centers, bandwidths and initial params of each seed as the
    script draws them, no fit; with `--cap`, also the multipliers of every
    epoch of the config at that capacity."""
    import jax

    from st_dadk_tpu.config import ExperimentConfig

    out = args.output_dir
    out.mkdir(parents=True, exist_ok=True)
    cfg = ExperimentConfig.from_yaml(args.config)
    z_train, z_test, coords, _, meta = script.load_kaust_csv(
        f"{FAMILY_STEM}_train.csv", f"{FAMILY_STEM}_test.csv",
        normalize=True, verbose=False)
    tt, ss = np.nonzero(~np.isnan(z_train))
    for seed in args.seeds:
        # scripts/predict_submission.py:73-99, without the fit
        perm = np.random.default_rng(seed).permutation(len(tt))
        train_coords = None
        if cfg.spatial_init_method in script.DATA_ADAPTIVE_INIT_METHODS:
            train_coords = coords[ss[perm[:int(0.9 * len(tt))]]].astype(
                np.float32)
        np.random.seed(seed)
        centers, bw = script.init_spatial_centers(
            cfg.spatial_init_method, cfg.k_spatial_centers, train_coords,
            key=jax.random.PRNGKey(seed))
        params, consts = script.init_model(
            jax.random.PRNGKey(seed), script.spec_from_config(cfg), centers,
            bw)
        shuffle = ({} if args.cap is None else {
            "cap": args.cap,
            "multipliers": jax_multipliers(seed, args.cap, cfg.epochs)})
        np.savez(out / f"init_{seed}.npz", centers=np.asarray(centers),
                 bw=np.asarray(bw), **shuffle,
                 **{f"params/{k}": v for k, v in _flat(params).items()},
                 **{f"consts/{k}": v for k, v in _flat(consts).items()})
        print(f"init {seed}: {out / f'init_{seed}.npz'}", flush=True)
    return 0


def run_torch(args) -> int:
    import torch

    from st_dadk_tpu_torch.cli import predict_submission as cli
    from st_dadk_tpu_torch.models.st_interp import from_jax_params
    from st_dadk_tpu_torch.train import loop as tloop

    if args.device == "cuda" and not torch.cuda.is_available():
        print("port_accuracy_paired: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out = args.output_dir
    out.mkdir(parents=True, exist_ok=True)
    config = (args.config if args.keep_dropout
              else paired_config(args.config, out, args.epochs))
    for seed in args.seeds:
        d = np.load(args.init_dir / f"init_{seed}.npz")
        params = _nest({k[len("params/"):]: d[k] for k in d.files
                        if k.startswith("params/")})
        consts = _nest({k[len("consts/"):]: d[k] for k in d.files
                        if k.startswith("consts/")})
        if args.ulp:
            params = _nest({k: np.nextafter(v, np.float32(np.inf))
                            if v.dtype == np.float32 else v
                            for k, v in _flat(params).items()})
        epochs = None if args.own_shuffle else iter(d["multipliers"])
        seen = {}
        patched = {"init_spatial_centers": cli.init_spatial_centers,
                   "init_model": cli.init_model, "fit": cli.fit}

        def centers(method, ks, coords, generator, device, rng):
            return (torch.as_tensor(d["centers"], device=device),
                    torch.as_tensor(d["bw"], device=device))

        def init(generator, spec, centers_, bw, device):
            return from_jax_params(spec, params, consts, device=device)

        def fit_capture(*a, **kw):
            seen["result"] = patched["fit"](*a, **kw)
            return seen["result"]

        def multipliers(cap, generator, device):
            if cap != int(d["cap"]):
                raise ValueError(f"capacity {cap}, JAX's {int(d['cap'])}")
            return torch.as_tensor(next(epochs), dtype=torch.int64,
                                   device=device)

        hash_multipliers = tloop.hash_multipliers
        cli.init_spatial_centers, cli.init_model = centers, init
        cli.fit = fit_capture
        if epochs is not None:
            tloop.hash_multipliers = multipliers
        sub = out / f"submission_{seed}.csv"
        t0 = time.time()
        try:
            cli.main(["--family", str(FAMILY_STEM), "--config", str(config),
                      "--seed", str(seed), "--out", str(sub),
                      "--device", args.device]
                     + (["--epochs", str(args.epochs)]
                        if args.keep_dropout and args.epochs else []))
        finally:
            for name, fn in patched.items():
                setattr(cli, name, fn)
            tloop.hash_multipliers = hash_multipliers
        result = seen["result"]
        write_row(out, seed, sub, _history(result.history),
                  result.n_epochs_run, time.time() - t0)
    card = "CPU host"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    (out / "run_info.json").write_text(json.dumps({
        "hardware": card, "ulp": args.ulp, "keep_dropout": args.keep_dropout,
        "own_shuffle": args.own_shuffle}))
    return 0


def write_row(out: Path, seed: int, sub: Path, history: dict,
              n_epochs: int, seconds: float) -> None:
    """Append one seed's scores and history to out/scores.json."""
    sys.path.insert(0, str(REPO / "scripts"))
    from port_accuracy_competition import family, scores

    path = out / "scores.json"
    rows = json.loads(path.read_text()) if path.exists() else []
    rows = [r for r in rows if r["seed"] != seed]
    row = {"seed": seed, "epochs_run": int(n_epochs), "seconds": seconds,
           **scores(family(), sub), "history": history}
    rows.append(row)
    path.write_text(json.dumps(rows))
    print(json.dumps({k: v for k, v in row.items() if k != "history"}),
          flush=True)


def first_past(a, b, gap):
    """First epoch (1-based) where |a - b| / |b| exceeds `gap`, else None."""
    for e, (x, y) in enumerate(zip(a, b)):
        if not (abs(x - y) <= gap * abs(y)):
            return e + 1
    return None


def compare(runs, out_path) -> str:
    data = {}
    for spec in runs:
        name, d = spec.split("=", 1)
        data[name] = {r["seed"]: r for r in json.loads(
            (Path(d) / "scores.json").read_text())}
    names = list(data)
    ref = names[0]
    seeds = sorted(set.intersection(*(set(v) for v in data.values())))
    lines = ["| seed | " + " | ".join(f"{n} RMSE | {n} MAE" for n in names)
             + " | " + " | ".join(
                 f"{n}: val loss past {', '.join(f'{g:g}' for g in GAPS)} "
                 f"at epoch | {n} - {ref} RMSE" for n in names[1:]) + " |",
             "|---" * (1 + 2 * len(names) + 2 * (len(names) - 1)) + "|"]
    for s in seeds:
        cells = [f"{data[n][s]['rmse']!r} | {data[n][s]['mae']!r}"
                 for n in names]
        for n in names[1:]:
            a = data[n][s]["history"]["val_loss"]
            b = data[ref][s]["history"]["val_loss"]
            cells.append(", ".join(str(first_past(a, b, g)) for g in GAPS)
                         + f" | {data[n][s]['rmse'] - data[ref][s]['rmse']:+.6f}")
        lines.append(f"| {s} | " + " | ".join(cells) + " |")
    for n in names:
        v = np.array([data[n][s]["rmse"] for s in seeds])
        lines.append(f"\n`{n}`: RMSE mean {float(v.mean())!r}, std "
                     f"{float(v.std())!r} over {len(v)} seeds")
    lines.append("\nEvery fit starts from JAX's centers and initial params, "
                 "draws JAX's hash multipliers each epoch and runs without "
                 "dropout; 'None' means the gap never passed that share.")
    text = "\n".join(lines) + "\n"
    if out_path:
        Path(out_path).write_text(text)
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", choices=["jax", "torch"])
    ap.add_argument("--output_dir", type=Path)
    ap.add_argument("--init_dir", type=Path,
                    help="the JAX side's --output_dir (torch side)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[2025, 2026])
    ap.add_argument("--config", type=Path, default=CONFIG)
    ap.add_argument("--epochs", type=int, default=None,
                    help="cut the 500-epoch cap")
    ap.add_argument("--ulp", action="store_true",
                    help="move every initial param by one ulp (torch side)")
    ap.add_argument("--init_only", action="store_true",
                    help="JAX side: write the inits (and with --cap the "
                    "multipliers) of the config as it is, no fit")
    ap.add_argument("--cap", type=int, default=None,
                    help="JAX side, --init_only: the fit's capacity")
    ap.add_argument("--keep_dropout", action="store_true",
                    help="torch side: the config's dropout (the port's own "
                    "dropout stream), not 0")
    ap.add_argument("--own_shuffle", action="store_true",
                    help="torch side: the port's own hash multipliers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare", nargs="+", default=None,
                    help="NAME=DIR of each side's --output_dir, JAX first")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.compare:
        print(compare(args.compare, args.out))
        return 0
    if args.side == "jax" and args.output_dir:
        return run_jax(args)
    if args.side == "torch" and args.output_dir and args.init_dir:
        return run_torch(args)
    ap.error("--side jax --output_dir, --side torch --output_dir "
             "--init_dir, or --compare")
    return 2


if __name__ == "__main__":
    sys.exit(main())
