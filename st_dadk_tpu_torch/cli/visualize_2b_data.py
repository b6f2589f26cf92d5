"""A spatio-temporal dataset at a glance (port of the JAX package's
`scripts/visualize_2b_data.py`): the spatial map at one time beside the
time series of a few sites; an (x, y, z) file with one time gets the value
histogram in place of the series.

    python3 -m st_dadk_tpu_torch.cli.visualize_2b_data \\
        [--data_file data/2a/2a_8.csv] [--t 50] [--n_series 5] [--out F]

`figure_arrays` gives the plotted arrays; matplotlib is imported only when
the figure is drawn. The figure goes to `--out`, by default
`<data file stem>_viz.png`.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.dataio.kaust import load_kaust_csv_single


def figure_arrays(z: np.ndarray, t: int, n_series: int) -> Dict:
    """The arrays of the figure: the 0-based time `t_idx` of the 1-based
    `t` (clamped to the data), the map `z[t_idx]`, and either the `sites`
    drawn by default_rng(0) with their `series` z[:, sites] (T > 1) or the
    finite values of the only time, `hist`."""
    T, S = z.shape
    t_idx = min(max(t - 1, 0), T - 1)
    out = {"t_idx": t_idx, "map": z[t_idx]}
    if T > 1:
        sites = np.random.default_rng(0).choice(S, size=min(n_series, S),
                                                replace=False)
        out.update(sites=sites, series=z[:, sites])
    else:
        out["hist"] = z[0][np.isfinite(z[0])]
    return out


def plot(coords: np.ndarray, arrays: Dict, name: str, out: str) -> None:
    from st_dadk_tpu_torch.viz.plots import _pyplot
    plt = _pyplot()
    fig = plt.figure(figsize=(14, 6))
    ax1 = fig.add_subplot(1, 2, 1)
    sc = ax1.scatter(coords[:, 0], coords[:, 1], c=arrays["map"], s=8,
                     cmap="RdBu_r")
    ax1.set_title(f"{name} at t={arrays['t_idx'] + 1}")
    ax1.set_aspect("equal")
    plt.colorbar(sc, ax=ax1, shrink=0.8)
    ax2 = fig.add_subplot(1, 2, 2)
    if "series" in arrays:
        T = arrays["series"].shape[0]
        for s, col in zip(arrays["sites"], arrays["series"].T):
            ax2.plot(np.arange(1, T + 1), col, lw=1,
                     label=f"({coords[s, 0]:.2f},{coords[s, 1]:.2f})")
        ax2.set_xlabel("t")
        ax2.set_ylabel("z")
        ax2.legend(fontsize=8)
        ax2.set_title("sample site time series")
    else:
        ax2.hist(arrays["hist"], bins=60)
        ax2.set_title("value distribution (spatial-only file)")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The JAX script's flags and defaults."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_file", type=str, default="data/2a/2a_8.csv")
    parser.add_argument("--t", type=int, default=50, help="1-based time slice")
    parser.add_argument("--n_series", type=int, default=5)
    parser.add_argument("--out", type=str, default=None)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)

    cfg = ExperimentConfig(data_file=args.data_file)
    z, coords, _ = load_kaust_csv_single(cfg.resolve_data_file(),
                                         normalize=False, verbose=True)
    stem = Path(args.data_file).stem
    out = args.out or f"{stem}_viz.png"
    plot(coords, figure_arrays(z, args.t, args.n_series), stem, out)
    print(f"saved -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
