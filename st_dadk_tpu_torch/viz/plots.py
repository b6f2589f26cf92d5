"""Figure families for per-experiment diagnostics (port of
`st_dadk_tpu/viz/plots.py`).

Training curves, prediction heatmaps, the per-site spatial MSE map, per-site
temporal series with quantile fans, observation-pattern maps, basis
evolution, the combined per-tau fan chart and the two cross-experiment
summary maps. matplotlib (Agg) and scipy's `griddata` are imported inside
the functions, so importing this module needs neither: where matplotlib is
missing, a figure raises ImportError, which the callers catch and report
as the JAX package does. The figures that predict take the serving model
(an `STInterp`) in place of the JAX (spec, params, consts).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend (files only, no display)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_training_curves(history: Dict[str, list], path: Path) -> None:
    """Loss / RMSE / LR panels (ref :989-1053)."""
    plt = _pyplot()
    epochs = np.arange(1, len(history["train_loss"]) + 1)
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    axes[0].plot(epochs, history["train_loss"], label="train")
    axes[0].plot(epochs, history["val_loss"], label="valid")
    axes[0].set_xlabel("epoch"); axes[0].set_ylabel("loss")
    axes[0].set_title("Loss"); axes[0].legend(); axes[0].grid(alpha=0.3)
    axes[1].plot(epochs, history["val_rmse"], color="tab:green")
    axes[1].set_xlabel("epoch"); axes[1].set_ylabel("val RMSE")
    axes[1].set_title("Validation RMSE"); axes[1].grid(alpha=0.3)
    axes[2].plot(epochs, history["lr"], color="tab:red")
    axes[2].set_xlabel("epoch"); axes[2].set_ylabel("lr")
    axes[2].set_title("Learning rate"); axes[2].grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def _site_scatter(ax, coords: np.ndarray, values: np.ndarray, title: str,
                  cmap: str = "viridis", vmin=None, vmax=None):
    plt = _pyplot()
    sc = ax.scatter(coords[:, 0], coords[:, 1], c=values, s=6, cmap=cmap,
                    vmin=vmin, vmax=vmax)
    ax.set_title(title)
    ax.set_xlim(0, 1); ax.set_ylim(0, 1); ax.set_aspect("equal")
    plt.colorbar(sc, ax=ax, shrink=0.8)


def plot_observation_pattern(coords: np.ndarray, obs_mask: np.ndarray,
                             train_mask: np.ndarray, valid_mask: np.ndarray,
                             output_dir: Path) -> None:
    """2x2 per-site observation-count maps (ref :1558-1634)."""
    plt = _pyplot()
    test_mask = ~obs_mask
    fig, axes = plt.subplots(2, 2, figsize=(11, 10))
    for ax, (mask, title) in zip(
            axes.ravel(),
            [(obs_mask, "observed"), (train_mask, "train"),
             (valid_mask, "valid"), (test_mask, "test")]):
        _site_scatter(ax, coords, mask.sum(axis=0), f"{title} counts per site")
    fig.suptitle("Observation pattern")
    fig.tight_layout()
    fig.savefig(Path(output_dir) / "observation_pattern.png", dpi=100)
    plt.close(fig)


def plot_predictions(cfg, model, z_full: np.ndarray,
                     coords: np.ndarray, train_mask: np.ndarray,
                     output_dir: Path, n_times: int = 3) -> None:
    """True / predicted / bias heatmaps at random time slices, interpolated
    to a 200x200 grid with train-site and basis-center overlays — reference
    layout (ref :1056-1192: nearest-neighbor griddata, pcolormesh, black
    train dots, red 'x' centers sized by bandwidth, RdBu_r bias with
    symmetric limits, seed 42 time selection)."""
    plt = _pyplot()
    from scipy.interpolate import griddata

    from st_dadk_tpu_torch.train.loop import predict

    T, S = z_full.shape
    # local generator: finalize runs on a thread in the pipelined batch
    # engine, so plotting must not touch the global numpy RNG
    t_indices = sorted(np.random.default_rng(42).choice(T, size=min(n_times, T),
                                        replace=False))

    centers, bandwidths = (a.detach().cpu().numpy()
                           for a in model.spatial_params())
    bw_n = (bandwidths - bandwidths.min()) / (bandwidths.max()
                                              - bandwidths.min() + 1e-8)
    basis_sizes = 10 + bw_n * 90

    res = 200
    xi = np.linspace(0, 1, res)
    xi_g, yi_g = np.meshgrid(xi, xi)

    def overlay(ax, t_idx):
        tr = coords[np.where(train_mask[t_idx])[0]]
        ax.scatter(tr[:, 0], tr[:, 1], c="black", s=20, alpha=0.6,
                   label="Train sites", edgecolors="white", linewidths=0.5)
        ax.scatter(centers[:, 0], centers[:, 1], c="red", s=basis_sizes,
                   marker="x", alpha=0.5, label="Basis centers",
                   linewidths=1.5)
        ax.set_xlim(0, 1); ax.set_ylim(0, 1)
        ax.set_xlabel("x"); ax.set_ylabel("y")
        ax.legend(loc="upper right", fontsize=9)

    fig, axes = plt.subplots(len(t_indices), 3,
                             figsize=(20, 5 * len(t_indices)), squeeze=False)
    for row, t_idx in enumerate(t_indices):
        t_arr = np.full((S, 1), t_idx / (T - 1) if T > 1 else 0.0, np.float32)
        preds = predict(model, coords, t_arr)
        if cfg.regression_type == "multi-quantile":
            preds = preds[:, len(cfg.quantile_levels) // 2]
        else:
            preds = preds[:, 0]
        true = z_full[t_idx]
        valid = ~np.isnan(true)
        if not valid.any():
            # a fully-missing time slice would crash griddata (empty input)
            # and abort every remaining plot family; render a placeholder
            for col in range(3):
                axes[row][col].text(0.5, 0.5, f"t={t_idx+1}: no data",
                                    ha="center", va="center")
                axes[row][col].set_xlim(0, 1); axes[row][col].set_ylim(0, 1)
            continue
        cv = coords[valid]
        bias = preds - true
        tg = griddata(cv, true[valid], (xi_g, yi_g), method="nearest")
        pg = griddata(cv, preds[valid], (xi_g, yi_g), method="nearest")
        bg = griddata(cv, bias[valid], (xi_g, yi_g), method="nearest")

        im = axes[row][0].pcolormesh(xi_g, yi_g, tg, cmap="viridis",
                                     shading="auto")
        axes[row][0].set_title(f"t={t_idx+1} - True", fontweight="bold")
        overlay(axes[row][0], t_idx)
        plt.colorbar(im, ax=axes[row][0])

        im = axes[row][1].pcolormesh(xi_g, yi_g, pg, cmap="viridis",
                                     shading="auto")
        axes[row][1].set_title(f"t={t_idx+1} - Predicted", fontweight="bold")
        overlay(axes[row][1], t_idx)
        plt.colorbar(im, ax=axes[row][1])

        bmax = float(np.nanmax(np.abs(bias[valid]))) or 1.0
        im = axes[row][2].pcolormesh(xi_g, yi_g, bg, cmap="RdBu_r",
                                     shading="auto", vmin=-bmax, vmax=bmax)
        axes[row][2].set_title(f"t={t_idx+1} - Bias (Pred - True)",
                               fontweight="bold")
        overlay(axes[row][2], t_idx)
        plt.colorbar(im, ax=axes[row][2])

    fig.tight_layout()
    fig.savefig(Path(output_dir) / "prediction_maps.png", dpi=110,
                bbox_inches="tight")
    plt.close(fig)


def select_coverage_sites(coords: np.ndarray, train_mask: np.ndarray,
                          n_sites: int = 4) -> List[int]:
    """Deterministic site selection with spatial coverage: one train site
    nearest the domain center, then region-grid representatives
    (ref :1333-1370)."""
    selected: List[int] = []
    sites_with_train = np.where(train_mask.sum(axis=0) > 0)[0]
    if len(sites_with_train):
        d = np.linalg.norm(coords[sites_with_train] - 0.5, axis=1)
        selected.append(int(sites_with_train[np.argmin(d)]))
    n_grid = int(np.ceil(np.sqrt(n_sites)))
    for i in range(n_grid):
        for j in range(n_grid):
            if len(selected) >= n_sites:
                break
            x0, x1 = i / n_grid, (i + 1) / n_grid
            y0, y1 = j / n_grid, (j + 1) / n_grid
            in_region = ((coords[:, 0] >= x0) & (coords[:, 0] < x1)
                         & (coords[:, 1] >= y0) & (coords[:, 1] < y1))
            if in_region.sum():
                rc = np.array([(x0 + x1) / 2, (y0 + y1) / 2])
                d = np.linalg.norm(coords[in_region] - rc, axis=1)
                g = int(np.where(in_region)[0][np.argmin(d)])
                if g not in selected:
                    selected.append(g)
    return selected or [0]


def _quantile_colors(n: int):
    """The reference's vivid rainbow quantile palette (ref :1497-1509)."""
    plt = _pyplot()
    if n == 3:
        return ["#0000FF", "#00CC00", "#FF0000"]
    if n == 5:
        return ["#0000FF", "#00CCCC", "#00CC00", "#FF8800", "#FF0000"]
    if n == 7:
        return ["#8B00FF", "#0000FF", "#00CCCC", "#00CC00", "#FFCC00",
                "#FF8800", "#FF0000"]
    return plt.cm.tab10(np.linspace(0, 0.9, n))


def plot_spatial_mse(z_full: np.ndarray, coords: np.ndarray,
                     all_predictions: np.ndarray, train_mask: np.ndarray,
                     output_dir: Path) -> None:
    """Per-site time-averaged MSE map (ref :1196-1300)."""
    plt = _pyplot()
    err = (all_predictions - z_full) ** 2
    site_mse = np.nanmean(err, axis=0)
    fig, ax = plt.subplots(figsize=(7, 6))
    _site_scatter(ax, coords, site_mse, "per-site time-avg MSE", cmap="magma")
    n_train_per_site = train_mask.sum(axis=0)
    obs_sites = n_train_per_site > 0
    ax.scatter(coords[obs_sites, 0], coords[obs_sites, 1], s=12,
               facecolors="none", edgecolors="cyan", linewidths=0.4,
               label="train sites")
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(Path(output_dir) / "spatial_mse.png", dpi=100)
    plt.close(fig)


def plot_temporal_series(cfg, model, z_full: np.ndarray,
                         coords: np.ndarray, train_mask: np.ndarray,
                         valid_mask: np.ndarray, test_mask: np.ndarray,
                         output_dir: Path, n_sites: int = 4) -> None:
    """Per-site time series with reference layout (ref :1303-1555):
    coverage-selected sites, prediction line, observed (black) vs test
    (gray) circles; for multi-quantile additionally the combined per-tau
    panel figure with the reference's rainbow quantile lines
    (temporal_series_quantiles_combined.png)."""
    plt = _pyplot()
    from st_dadk_tpu_torch.train.loop import predict
    T, S = z_full.shape
    chosen = select_coverage_sites(coords, train_mask, n_sites)

    t_vals = (np.arange(T, dtype=np.float32) / max(T - 1, 1))[:, None]
    tt = np.arange(1, T + 1)
    preds_by_site = {}
    for s in chosen:
        c = np.tile(coords[s], (T, 1))
        preds_by_site[s] = predict(model, c, t_vals)

    def scatter_roles(ax, s):
        true = z_full[:, s]
        test_obs = test_mask[:, s]
        obs = train_mask[:, s] | valid_mask[:, s]
        if test_obs.sum():
            ax.scatter(tt[test_obs], true[test_obs], c="gray", s=40,
                       marker="o", alpha=0.7, label="Test (unobserved)",
                       zorder=3)
        if obs.sum():
            ax.scatter(tt[obs], true[obs], c="black", s=40, marker="o",
                       alpha=0.7, label="Train (observed)", zorder=3)

    multi = cfg.regression_type == "multi-quantile"
    med = len(cfg.quantile_levels) // 2 if multi else 0

    fig, axes = plt.subplots(len(chosen), 1, figsize=(14, 3.5 * len(chosen)),
                             squeeze=False)
    for row, s in enumerate(chosen):
        ax = axes[row][0]
        preds = preds_by_site[s]
        ax.plot(tt, preds[:, med], "b-", linewidth=2, label="Prediction",
                alpha=0.8)
        scatter_roles(ax, s)
        ax.set_title(f"Site {s} at ({coords[s,0]:.3f}, {coords[s,1]:.3f})",
                     fontweight="bold")
        ax.set_xlabel("Time"); ax.set_ylabel("Value")
        ax.legend(loc="center left", bbox_to_anchor=(1, 0.5), fontsize=9)
        ax.grid(True, alpha=0.3)
    fig.tight_layout(rect=[0, 0, 0.85, 1])
    fig.savefig(Path(output_dir) / "temporal_series.png", dpi=110,
                bbox_inches="tight")
    plt.close(fig)

    if multi:
        qs = list(cfg.quantile_levels)
        colors = _quantile_colors(len(qs))
        fig, axes = plt.subplots(len(chosen), 1,
                                 figsize=(14, 3.5 * len(chosen)),
                                 squeeze=False)
        for row, s in enumerate(chosen):
            ax = axes[row][0]
            preds = preds_by_site[s]
            for qi, q in enumerate(qs):
                ax.plot(tt, preds[:, qi], color=colors[qi], linewidth=2,
                        alpha=0.8, label=f"tau={q}")
            scatter_roles(ax, s)
            ax.set_title(f"Site {s} at ({coords[s,0]:.3f}, "
                         f"{coords[s,1]:.3f}) - All Quantiles",
                         fontweight="bold")
            ax.set_xlabel("Time"); ax.set_ylabel("Value")
            ax.legend(loc="center left", bbox_to_anchor=(1, 0.5), fontsize=9)
            ax.grid(True, alpha=0.3)
        fig.tight_layout(rect=[0, 0, 0.85, 1])
        fig.savefig(Path(output_dir) / "temporal_series_quantiles_combined.png",
                    dpi=110, bbox_inches="tight")
        plt.close(fig)


def create_averaged_spatial_mse(experiment_dirs, summary_dir: Path) -> None:
    """Cross-experiment averaged per-site MSE map from each experiment's
    predictions.npz (ref train_st_interp.py:2636-2727)."""
    plt = _pyplot()
    site_mse_sum, coords, n = None, None, 0
    for d in experiment_dirs:
        f = Path(d) / "predictions.npz"
        if not f.exists():
            continue
        data = np.load(f)
        err = (data["predictions"] - data["true"]) ** 2
        with np.errstate(invalid="ignore"):
            site_mse = np.nanmean(err, axis=0)
        if site_mse_sum is None:
            site_mse_sum = np.zeros_like(site_mse)
            site_cnt = np.zeros_like(site_mse)
            coords = data["coords"]
        # per-site count of experiments with a FINITE value: an all-NaN
        # site folded in as 0 over the full count would bias never-observed
        # sites toward "best-predicted" on the summary map
        finite = np.isfinite(site_mse)
        site_mse_sum += np.where(finite, site_mse, 0.0)
        site_cnt += finite
        n += 1
    if n == 0:
        return
    with np.errstate(invalid="ignore"):
        avg = np.where(site_cnt > 0, site_mse_sum / np.maximum(site_cnt, 1),
                       np.nan)
    fig, ax = plt.subplots(figsize=(7, 6))
    _site_scatter(ax, coords, avg, f"per-site MSE averaged over {n} experiments",
                  cmap="magma")
    fig.tight_layout()
    Path(summary_dir).mkdir(parents=True, exist_ok=True)
    fig.savefig(Path(summary_dir) / "averaged_spatial_mse.png", dpi=110)
    plt.close(fig)


def create_observation_density_map(experiment_dirs, summary_dir: Path) -> None:
    """Cross-experiment per-site observation frequency from the stored masks
    (ref train_st_interp.py:2730-2787)."""
    plt = _pyplot()
    counts, coords, n = None, None, 0
    for d in experiment_dirs:
        f = Path(d) / "predictions.npz"
        if not f.exists():
            continue
        data = np.load(f)
        obs = data["train_mask"] | data["valid_mask"]
        if counts is None:
            counts = np.zeros(obs.shape[1], np.float64)
            coords = data["coords"]
        counts += obs.sum(axis=0)
        n += 1
    if n == 0:
        return
    fig, ax = plt.subplots(figsize=(7, 6))
    _site_scatter(ax, coords, counts / n,
                  f"mean observations per site over {n} experiments")
    fig.tight_layout()
    Path(summary_dir).mkdir(parents=True, exist_ok=True)
    fig.savefig(Path(summary_dir) / "observation_density.png", dpi=110)
    plt.close(fig)


def plot_combined_quantile_series(quantile_preds: Dict[float, np.ndarray],
                                  z_full: np.ndarray, coords: np.ndarray,
                                  train_mask: np.ndarray,
                                  test_mask: np.ndarray,
                                  output_dir: Path, n_sites: int = 4) -> None:
    """Fan chart combining SEPARATE per-tau models' dense predictions
    (the reference reloads per-tau checkpoints and renders a combined
    temporal plot, train_st_interp.py:2094-2150). quantile_preds maps
    tau -> (T, S) prediction fields."""
    plt = _pyplot()
    qs = sorted(quantile_preds.keys())
    T, S = z_full.shape
    rng = np.random.default_rng(0)
    pools = [np.where(train_mask.any(axis=0))[0],
             np.where(test_mask.all(axis=0))[0]]
    chosen: List[int] = []
    for pool in pools:
        if len(pool):
            chosen += list(rng.choice(pool, size=min(n_sites // 2, len(pool)),
                                      replace=False))
    chosen = chosen[:n_sites] or [0]

    tt = np.arange(1, T + 1)
    fig, axes = plt.subplots(len(chosen), 1, figsize=(12, 3 * len(chosen)),
                             squeeze=False)
    med = qs[len(qs) // 2]   # middle index, ref parity (:801/:915) — for
                             # even quantile counts this is an upper quantile
    for row, s in enumerate(chosen):
        ax = axes[row][0]
        for lo_i in range(len(qs) // 2):
            lo, hi = qs[lo_i], qs[len(qs) - 1 - lo_i]
            ax.fill_between(tt, quantile_preds[lo][:, s],
                            quantile_preds[hi][:, s], alpha=0.18,
                            color="tab:purple",
                            label=f"q{lo}-q{hi}" if row == 0 else None)
        ax.plot(tt, quantile_preds[med][:, s], color="tab:purple",
                label=f"q{med}" if row == 0 else None)
        ax.plot(tt, z_full[:, s], ".", ms=3, color="black",
                label="true" if row == 0 else None)
        role = "train" if train_mask[:, s].any() else "test"
        ax.set_title(f"site {s} ({role}) — separate per-tau models")
        if row == 0:
            ax.legend(ncol=4, fontsize=8)
    fig.tight_layout()
    fig.savefig(Path(output_dir) / "combined_quantile_series.png", dpi=100)
    plt.close(fig)


def inactive_basis_mask(first_layer_w: np.ndarray, k_spatial: int,
                        p_covariates: int = 0,
                        threshold_ratio: float = 0.01) -> np.ndarray:
    """Detect 'removed' bases by first-layer group norms below
    threshold_ratio x max norm (ref plot_basis_evolution,
    train_st_interp.py:1637-1933 + sparsity_threshold_ratio config)."""
    rows = first_layer_w[p_covariates:p_covariates + k_spatial]   # (k, h)
    norms = np.linalg.norm(rows, axis=1)
    return norms < threshold_ratio * max(norms.max(), 1e-12)


def plot_basis_evolution(centers_init: np.ndarray, bw_init: np.ndarray,
                         centers_final: np.ndarray, bw_final: np.ndarray,
                         train_coords: np.ndarray, output_dir: Path,
                         centers_history: Optional[List[Tuple[int, np.ndarray]]]
                         = None,
                         inactive: Optional[np.ndarray] = None) -> None:
    """Init vs final centers with movement traces and inactive-basis marks
    (ref :1637-1933)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(13, 6))
    for ax, (c, bw, title) in zip(axes, [
            (centers_init, bw_init, "initial"),
            (centers_final, bw_final, "final")]):
        if len(train_coords):
            sub = train_coords[np.random.default_rng(0).choice(
                len(train_coords), size=min(2000, len(train_coords)),
                replace=False)]
            ax.scatter(sub[:, 0], sub[:, 1], s=2, c="lightgray",
                       label="train points")
        sc = ax.scatter(c[:, 0], c[:, 1], s=18, c=bw, cmap="plasma")
        plt.colorbar(sc, ax=ax, shrink=0.8, label="bandwidth")
        ax.set_title(f"{title} basis centers")
        ax.set_xlim(-0.1, 1.1); ax.set_ylim(-0.1, 1.1); ax.set_aspect("equal")
    moved = np.linalg.norm(centers_final - centers_init, axis=1) > 1e-4
    for i in np.where(moved)[0]:
        axes[1].plot([centers_init[i, 0], centers_final[i, 0]],
                     [centers_init[i, 1], centers_final[i, 1]],
                     color="gray", lw=0.5, alpha=0.6)
    if centers_history:
        for epoch, cs in centers_history:
            axes[1].scatter(cs[:, 0], cs[:, 1], s=3, alpha=0.25, c="tab:orange")
    if inactive is not None and inactive.any():
        ina = centers_final[inactive]
        axes[1].scatter(ina[:, 0], ina[:, 1], s=60, facecolors="none",
                        edgecolors="red", linewidths=1.2,
                        label=f"inactive ({int(inactive.sum())})")
        axes[1].legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(Path(output_dir) / "basis_evolution.png", dpi=100)
    plt.close(fig)
