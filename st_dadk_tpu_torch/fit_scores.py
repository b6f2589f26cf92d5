"""Test and validation scores of chip_smoke.py's three fits at full
precision, from this checkout or another one, on one GPU.

    python3 -m st_dadk_tpu_torch.fit_scores [--tree DIR] [--shuffle MODE]
                                            [--out FILE]

The fits are chip_smoke.py's (`FITS`): the bench workload cut to `EPOCHS`
epochs (fused route), its ragged-k lane of 25 + 81 centers padded to 227
(materialised-phi route), and that lane unpadded; each is experiment 1
through `run_single_experiment` on the stand-in field. Prints each fit's
test and valid RMSE and CRPS as `repr` (every digit) with its kernel
launch counts, and writes `--out` (JSON).

  --tree DIR  run the fits with the `st_dadk_tpu_torch` package of another
              checkout, e.g. a `git archive` of the parent commit unpacked
              into a directory that .gitignore lists, so that two commits'
              scores compare bitwise within one call on one card.
  --shuffle MODE  the fits' `shuffle` (default: the config's own, 'auto');
              'perm' is the torch.randperm order every shuffle but 'none'
              took before the hash shuffle, so it compares a later tree
              with an earlier one bitwise.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
EPOCHS = 12                          # chip_smoke.py's EPOCHS
LANE_CENTERS, LANE_PAD = [25, 81], 227
FITS = {"bench": {},
        "ragged lane": {"k_spatial_centers": LANE_CENTERS,
                        "k_spatial_pad": LANE_PAD},
        "lane unpadded": {"k_spatial_centers": LANE_CENTERS}}
SCORES = ("test_rmse", "test_crps", "valid_rmse", "valid_crps")


def _import_from(tree: Path):
    """The package modules the fits need, imported from `tree`'s
    `st_dadk_tpu_torch` (this module's own package is dropped first)."""
    for name in [m for m in sys.modules
                 if m == "st_dadk_tpu_torch"
                 or m.startswith("st_dadk_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(tree))
    mods = {nm: importlib.import_module(f"st_dadk_tpu_torch.{nm}") for nm in
            ("bench_workload", "dataio.synthetic", "train.experiment",
             "ops.fused_first_layer", "ops.spatial_basis_kernels")}
    where = Path(mods["bench_workload"].__file__).resolve()
    if tree not in where.parents:
        raise RuntimeError(f"st_dadk_tpu_torch came from {where}, not {tree}")
    return mods


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=None)
    ap.add_argument("--shuffle", default=None)
    ap.add_argument("--out", type=Path,
                    default=REPO / "build" / "fit_scores.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fit_scores: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = (args.tree or REPO).resolve()
    mods = _import_from(tree)
    kernels = (mods["ops.fused_first_layer"], mods["ops.spatial_basis_kernels"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}\ntree: {tree}\nshuffle: {args.shuffle or 'default'}",
          flush=True)
    shuffle = {} if args.shuffle is None else {"shuffle": args.shuffle}
    data_file = mods["dataio.synthetic"].bench_data_file()
    result = {"card": card, "tree": str(tree), "shuffle": args.shuffle,
              "fits": {}}
    for name, overrides in FITS.items():
        cfg = mods["bench_workload"].bench_workload(
            data_file=str(data_file), epochs=EPOCHS, save_artifacts=True,
            **overrides, **shuffle)
        for mod in kernels:
            mod.reset_launch_counts()
        res = mods["train.experiment"].run_single_experiment(
            cfg, 1, REPO / "build" / "fit_scores" / name.replace(" ", "_"),
            device="cuda", verbose=False)
        torch.cuda.synchronize()
        launches = {k: v for mod in kernels
                    for k, v in mod.launch_counts().items() if v}
        result["fits"][name] = {**{s: res[s] for s in SCORES},
                                "launches": launches}
        print(f"{name}: " + "  ".join(f"{s} {res[s]!r}" for s in SCORES)
              + f"  launches {json.dumps(launches)}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
