"""Observation density of the four Table 4.4 scenarios (port of the JAX
package's `scripts/visualize_obs_density.py`).

    python3 -m st_dadk_tpu_torch.cli.visualize_obs_density \\
        [--data_file data/2a/2a_8.csv] [--obs_ratio 0.1] [--intensity 10] \\
        [--seed 2025] [--out obs_density.png]

One panel a scenario (fixed or random sites, uniform or clustered at the
corner): each site coloured by the number of times it is observed under
the scenario's design (`dataio/obs_design.py`), titled with the share of
(t, s) cells observed. `scenario_counts` gives the plotted arrays;
matplotlib is imported only when the figure is drawn.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np

from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.dataio.kaust import load_kaust_csv_single
from st_dadk_tpu_torch.dataio.obs_design import (sample_observations,
                                                 spatial_obs_probs)

SCENARIOS = [
    ("Fixed / Uniform", "site-wise", "uniform"),
    ("Fixed / Clustered", "site-wise", "corner"),
    ("Random / Uniform", "random", "uniform"),
    ("Random / Clustered", "random", "corner"),
]


def scenario_counts(z: np.ndarray, coords: np.ndarray, obs_ratio: float,
                    intensity: float, seed: int) -> List[Dict]:
    """A panel a scenario: its title, the per-site observed counts (S,)
    and the observed share of the (T, S) cells, each scenario's mask drawn
    from `seed`."""
    panels = []
    for title, method, pattern in SCENARIOS:
        w = spatial_obs_probs(coords, pattern, intensity)
        mask, _ = sample_observations(z, coords, method, obs_ratio, w,
                                      seed=seed)
        panels.append({"title": title, "counts": mask.sum(axis=0),
                       "observed_share": float(mask.mean())})
    return panels


def plot(coords: np.ndarray, panels: List[Dict], out: str) -> None:
    from st_dadk_tpu_torch.viz.plots import _pyplot
    plt = _pyplot()
    fig, axes = plt.subplots(1, len(panels), figsize=(22, 5))
    for ax, p in zip(axes, panels):
        sc = ax.scatter(coords[:, 0], coords[:, 1], c=p["counts"], s=8,
                        cmap="viridis")
        ax.set_title(f"{p['title']}\n({p['observed_share'] * 100:.1f}% "
                     f"observed)")
        ax.set_aspect("equal")
        plt.colorbar(sc, ax=ax, shrink=0.8)
    fig.suptitle("Observation density by scenario")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The JAX script's flags and defaults."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_file", type=str, default="data/2a/2a_8.csv")
    parser.add_argument("--obs_ratio", type=float, default=0.1)
    parser.add_argument("--intensity", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=2025)
    parser.add_argument("--out", type=str, default="obs_density.png")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)

    cfg = ExperimentConfig(data_file=args.data_file)
    z, coords, _ = load_kaust_csv_single(cfg.resolve_data_file(),
                                         normalize=False, verbose=False)
    plot(coords, scenario_counts(z, coords, args.obs_ratio, args.intensity,
                                 args.seed), args.out)
    print(f"saved -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
