#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (st_dadk_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # full run (needs one CUDA card)
    python3 chip_smoke.py --kernels-only  # build + check + time the kernels

Phases, each of which fails the run (non-zero exit, no result line):
  1. build the two CUDA libraries from st_dadk_tpu_torch/csrc with nvcc and
     the two host libraries from native/ with g++, one compiler process
     each, all four at once;
  2. check that basis d coords' square root equals __fsqrt_rn for every
     float of its range; hold each of the seven kernels against its plain
     PyTorch version on the card, at the fit's shapes, two ragged ones and
     two with k > 256, for all three bases and a center lying exactly on a
     point; launch the forward, the four slab-summing kernels (fused dW,
     d centers and d coords, basis d centers) and basis d coords twice at
     N=32768 and at (200, 106, 48) and require bitwise equal outputs; at
     the three fit shapes, time kernel and plain version (CUDA events
     around 20 eager calls, host included, and the device time a launch
     from a CUDA-graph replay) beside the kernel's bound, and the launch
     floor: the device time a launch of a one-element in-place add under
     the same replay; the three kernels a fit trains through (fused
     forward, dW, d centers) with a lane axis, M fits in one launch: against
     the plain version at three (M, N, k, H), and the forward also at the
     shapes the lanes phase gives it in validation and in the dense predict,
     each lane and the M = 1 call bitwise equal to the two-dimensional call,
     two launches bitwise equal, and the device time a launch at M = 1, 4,
     8, 16; the same for the two kernels a ragged-k batch trains through
     (basis forward and d centers), with and without a per-lane column mask
     of different real widths: each lane bitwise the two-dimensional call on
     its real columns and exactly 0 on its masked ones;
  3. the bench-workload DA-STDK fit (12 epochs, basis unfreezing at epoch
     10) through `run_single_experiment`, on the fused route;
  4. a ragged-k lane of that workload (centers 25+81 padded to 227) through
     the materialised-phi kernels, and the same lane unpadded (fused route),
     whose test and valid RMSE it must match;
  5. the spatial gradient d yhat / d coords through both fitted models;
  6. the lanes phase: M = 4 seeds of the bench workload as lanes of one
     batched program through `run_multiple_experiments(engine="vmap")`:
     the results contract and the summary files on disk, the three kernels'
     launch counts (those of ONE fit, whatever M), and lane 0 of two runs at
     dropout 0 without shuffling against the single fit of the same seed,
     loss histories and test scores: the bench schedule, and three epochs
     with the basis training from the first step;
  7. the ragged-lanes phase: the grid {[25, 81], [25, 81, 121]} padded to
     227 centers x seeds 2025, 2026 as 4 lanes of one program through
     `run_job_batch`: the results contract at each lane's real shapes and
     real parameter count, the basis forward's and d centers' launch counts
     (those of ONE fit) with no fused launch, junk rows exactly 0 after
     training, each lane's RMSEs against its own unpadded single fit (as
     another sample of it with dropout and shuffling on; within the ragged
     bar at dropout 0 without shuffling), and lane 0 at dropout 0 without
     shuffling against the single padded-lane fit by the bars of phase 6;
  8. the pipeline phase: 6 jobs of that grid at 2 lanes a batch through
     `run_lane_jobs` (prepare and finalize threads) and as three batches one
     after another, in turns: results bitwise equal, both walls printed;
  9. the batched GMM init of phase 7's lanes against the lane-by-lane init:
     centers, bandwidths, EM iteration counts, seconds a lane both ways and
     the lane-by-lane init's split into seeding and EM;
 10. the 'random_site' and 'kmeans_balanced' inits of the same lanes,
     batched against lane by lane: random sites bitwise, balanced k-means
     with the same restart kept and centers within rtol 1e-4 / atol 1e-5,
     seconds a lane both ways beside phase 9's GMM;
 11. Table 4.4 through `st_dadk_tpu_torch/cli/run_table_4_4.py`'s `main` on
     configs/config_st_interp.yaml (device 'tpu', read by the port's YAML
     reader), 2 seeds x 12 epochs a cell, engine vmap: 8 finite CRPS values,
     STDK's centers the uniform grid after training, DA-STDK's moved and
     lane 1's initial centers its balanced k-means alone, fused kernels
     only;
 12. per-tau quantile fits of the bench workload (taus 0.1 / 0.5 / 0.9 x
     2 seeds = 6 lanes) through `run_multiple_experiments(engine="vmap")`:
     the quantile_<q>/ trees and the aggregated results.json, then lane
     (2025, 0.5) at dropout 0, no shuffling, 3 epochs with the basis
     unfrozen against its single fit (losses at phase 6's early bar, the
     center shift by its one-ulp drift rule);
 13. `run_grid_search` over {uniform+fixed, kmeans_balanced+learnable} x
     {[25, 81], [25, 81, 121]}, 2 seeds, vmap: the four CSV/JSON files, one
     summary a config, two ragged buckets padded to 227 on the phi route
     with their junk rows exactly 0;
 14. the host libraries: the exact k-means (`kmeans_constrained`) on phase
     7's lane 0 subsample at k = 25 / 81 / 121 with the native transport
     solver and with its plain version, the HiGHS LP, seconds both ways:
     bitwise equal centers and labels where k is below the number of
     distinct sites, and at every k the two solvers' plans of one
     assignment (at each run's final centers) of equal cost (where k
     exceeds the sites, clusters share a site, the optimal plan is not
     unique and the two solvers may pick different optima); the stand-in
     CSV through the native loader and the numpy reader, bitwise equal;
 15. Table 4.4 as phase 11 with `--da_stdk_init_method kmeans_exact`: every
     DA-STDK lane's initial centers bitwise its exact k-means alone, fused
     kernels only;
 16. the hash shuffle: the permutation on the card bitwise the CPU's and a
     permutation, with one set of multipliers and a lane axis; the bench
     fit under `shuffle: perm` (the port's earlier shuffle), its scores
     printed beside phase 3's under the default `auto`;
 17. checkpoint and resume: the bench fit, 6 epochs straight against 3
     epochs into a checkpoint and a resume to 6, bitwise (histories,
     serving and final params); a fit whose LR overflows writes
     nan_diagnostics.json; a fit with `save_plots: true` completes, with
     the warning and no figure where matplotlib is missing;
 18. the competition submission: a family in 2a's layout cut from the
     stand-in field (`dataio/competition.py`: train t = 1..90 with a seeded
     share of rows dropped, test t = 91..100 at every site, the solutions)
     through `cli/predict_submission.py`'s `main` on
     configs/config_st_interp.yaml at full width, 12 epochs: one finite
     value a test row, RMSE / MAE against the solutions, the fused
     forward's, dW's and d centers' launches, and each held against its
     plain version and timed (device time a launch, beside the plain
     version's) at the step's shape (N = 4096);
 19. the forecast: `cli/forecast_submission.py` on that family at
     ForecastSpec's defaults, batch 4096, 20 epochs: one finite value a test
     row, RMSE beside persistence, the phi forward's launches (steps,
     validations and the forecast) and no launch of a basis backward or
     fused kernel; then the phi kernel against its plain version at the
     forecaster's shapes (k = 106 fixed centers, N = 4096 and the
     validation rows) and through `models/legacy_basis.embed` (k = 227),
     and held and timed at the step's shape;
 20. a bench-workload fit with no hidden layer (`hidden_dims: []`, no
     sparsity penalty, which needs a first layer), 12 epochs, on the phi
     route: phi forward and basis d centers launched, no
     fused kernel; then `cli/analyze_table_4_4.py` on phase 11's tree and
     `cli/analyze_grid_search.py` on phase 13's (their CSVs; figures only
     where matplotlib is installed);
 21. every kernel against its plain version at each shape (N, k, H, basis)
     a counted run of phases 3-20 launched it at without a lane axis or a
     column mask (the wrappers keep their launch shapes): the step, the
     validation and the prediction chunks of every fit, seeded inputs,
     the bars of phase 2.
Each of phases 3-7, 11-13, 15 and 18-20 sets the launch counts to 0 just
before it and reads them just after; it checks the fit's losses, centers
and test metrics. The last line of standard output is one JSON object with
"ok" and the device; the line before it lists the kernels, with the launches
of phases 18-20 under "competition_launches" and, as "max_abs_err", the
worst difference from the plain version in phases 2, 18-19 and 21.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
FUSED_SRC = "st_dadk_tpu_torch/csrc/fused_first_layer.cu"
BASIS_SRC = "st_dadk_tpu_torch/csrc/spatial_basis.cu"
# kernel wrapper -> (source, the TPU kernel it replaces)
KERNELS = {
    "fused_first_layer_fwd": (FUSED_SRC, "st_dadk_tpu/ops/pallas_fused.py:48"),
    "fused_first_layer_bwd_w": (FUSED_SRC,
                                "st_dadk_tpu/ops/pallas_fused.py:129"),
    "fused_first_layer_bwd_centers": (FUSED_SRC,
                                      "st_dadk_tpu/ops/pallas_fused.py:170"),
    "fused_first_layer_bwd_points": (FUSED_SRC,
                                     "st_dadk_tpu/ops/pallas_fused.py:147"),
    "spatial_basis_fwd": (BASIS_SRC, "st_dadk_tpu/ops/pallas_basis.py:70"),
    "spatial_basis_bwd_points": (BASIS_SRC,
                                 "st_dadk_tpu/ops/pallas_basis.py:113"),
    "spatial_basis_bwd_centers": (BASIS_SRC,
                                  "st_dadk_tpu/ops/pallas_basis.py:135"),
}
# fit shapes: training step (N=512), validation (N=2000), predict chunk
# (N=32768) at k=227 bench centers and H=256 first hidden width
SLICE_SHAPES = [(512, 227, 256), (2000, 227, 256), (32768, 227, 256)]
RAGGED_SHAPE = (200, 106, 48)
# H not a multiple of 4: the split-N kernels stage g and W with 4-byte
# copies instead of 16-byte ones
ODD_SHAPE = (77, 37, 19)
# k past one block of 256 threads: the basis forward takes one chunk of
# centers at four a thread (k % 4 == 0) or two chunks at one (k odd), and
# the fused d coords five k-slabs
WIDE_K_SHAPES = [(1000, 300, 64), (1000, 301, 64)]
# the kernels that sum slab partials in a fixed order, and the forward and
# basis d coords, which sum over k in one: launched twice at these shapes,
# each must give bitwise equal outputs
TWO_LAUNCHES = ("fused_first_layer_fwd", "fused_first_layer_bwd_w",
                "fused_first_layer_bwd_centers",
                "fused_first_layer_bwd_points", "spatial_basis_bwd_centers",
                "spatial_basis_bwd_points")
DETERMINISM_SHAPES = (SLICE_SHAPES[-1], RAGGED_SHAPE)
# the kernels with a lane axis, and their (M, N, k, H) cases: the step's
# shape at 4 and 16 lanes, and the odd shape (H % 4 != 0, k odd) at 3
LANE_KERNELS = ("fused_first_layer_fwd", "fused_first_layer_bwd_w",
                "fused_first_layer_bwd_centers")
LANE_SHAPES = [(4, 512, 227, 256), (3, 77, 37, 19), (16, 512, 227, 256)]
LANE_TWO_LAUNCHES = LANE_SHAPES[-1]
# the forward alone at the shapes the lanes phase gives it with LANES lanes:
# validation (about 2,000 points a lane: any N in 993..4032 takes the same
# tile), a full chunk of the dense predict and its last chunk (100 x 1000
# points in chunks of 32,768 leave 1,696); each takes another tile than the
# step's N=512
LANE_FWD_SHAPES = [(4, 2000, 227, 256), (4, 32768, 227, 256),
                   (4, 1696, 227, 256)]
LANE_TIMED = (1, 4, 8, 16)      # lanes timed at the step's shape
# the lane axis and column mask of the two kernels a ragged batch trains
# through; a lane's real width under the mask cycles through these shares
# of k (106 and 227 of 227: the grid's two resolutions; one lane fully real)
BASIS_LANE_KERNELS = ("spatial_basis_fwd", "spatial_basis_bwd_centers")
MASK_REAL_OF_227 = (106, 227, 151, 1)
# the lanes phase: seeds base_seed .. base_seed + LANES - 1
LANES = 4
# lane 0 against its single fit at dropout 0, shuffle none: relative gap of
# the train and validation loss histories. The two run the same arithmetic
# in other kernels (bmm for mm, another layer norm), and at lr 2e-2 AdamW's
# normalised updates amplify a rounding difference from epoch to epoch: a
# single fit whose W_s is moved by one ulp drifts from itself by 1e-2 in 12
# epochs. So the first epochs show that the lane loop is the single loop,
# and later the lane may drift from its single fit no further than
# LANE_DRIFT_FACTOR times what that one-ulp change does (running maxima).
# The bench schedule freezes the basis until epoch 10, so a second pair
# runs LANE_EARLY_EPOCHS epochs with the basis training from the first step:
# the per-lane d-centers gradient, center damping, the basis clipping group
# and the basis LR column are then held at the early bar, and so are lane
# 0's scores, which come through the lane forward of the dense predict
# (measured on an H100: histories within 2.3e-7, scores within 1.6e-8; the
# bars are 10x that)
LANE_EARLY_EPOCHS, LANE_EARLY_RTOL = 3, 3e-6
LANE_DRIFT_FACTOR = 10.0
LANE_SCORE_RTOL = 1e-6
LANE_SCORES = ("test_rmse", "test_crps", "valid_rmse", "valid_crps")
# peak rates of one H100 SXM (NVIDIA's data sheet): a 3xTF32 product takes
# three TF32 products on the tensor cores; float32 outside them; HBM
TF32X3_FLOPS, F32_FLOPS, HBM_BYTES_S = 495e12 / 3, 67e12, 3.35e12
# float32 operations of one (point, center) pair: phi, and the phi' chain
PHI_OPS, DPHI_OPS = 20, 25
# the basis unfreezes at epoch 10 of the bench workload: 12 epochs train the
# centers for two
EPOCHS = 12
# the ragged lane: the narrower lane of a grid over {[25,81],[25,81,121]}
LANE_CENTERS, LANE_PAD = [25, 81], 227
# the ragged-lanes phase: that grid x these experiment ids (seeds 2025, 2026)
RAGGED_GRID = ([25, 81], [25, 81, 121])
RAGGED_IDS = (1, 2)
# the pipeline phase: jobs, and lanes a batch
PIPELINE_JOBS, PIPELINE_WIDTH = 6, 2
# the batched GMM init against the lane-by-lane init, centers and bandwidths:
# a lane's EM takes its sums a run at a time whatever shares its batch
INIT_BATCH_ATOL = 0.0
# and with every second lane cut to this many training points, under the
# 10,000-point cap and odd: lanes of two subsample sizes in one call
UNEQUAL_INIT_POINTS = 7001
LANE_RMSE_BAR = 5e-3            # tests/test_ragged_k.py:171
# a lane of the lane engine against its single fit with dropout and
# shuffling on, after EPOCHS epochs: the lane draws other dropout masks and
# another batch order than its single fit (train/loop.py), so it is another
# sample of the same fit, and at lr 2e-2 even a one-ulp change moves a fit's
# scores by 5e-3 in 12 epochs (the lanes phase prints it). Measured on an
# H100: test RMSE 2.8e-3 to 4.6e-3, valid RMSE (2,000 points) 1.2e-3 to
# 8.0e-3 apart, where lanes of two seeds differ by up to 2e-2. The bar of
# tests/test_ragged_k.py holds where the two runs share their streams: the
# padded single fit (phase 4), and every ragged lane at dropout 0 without
# shuffling in its first epochs (RAGGED_QUIET_EPOCHS)
LANE_STREAM_BAR = 2e-2
# there the two runs differ only in their kernels' float32 sums (measured on
# an H100: the three RMSEs of every lane at most 9e-6 apart; the bar is 10x
# that, far inside LANE_RMSE_BAR and the 2e-2 between seeds)
RAGGED_QUIET_EPOCHS, RAGGED_QUIET_BAR = 3, 1e-4
GRAD_POINTS = 2000
# phase 10: the batched balanced k-means against the lane-by-lane one: the
# same restart kept, and centers within the JAX package's bar for its own
# batched init (tests/test_init_centers.py:198-202); `_bkm` arranges its
# sums to be bitwise, which the phase prints. Its first version summed over
# all runs at once and kept another restart for one lane of four (an H100)
KMB_BATCH_RTOL, KMB_BATCH_ATOL = 1e-4, 1e-5
# phase 11: Table 4.4 through its CLI, cut to 12 epochs of 2 seeds a cell
TABLE_SEEDS, TABLE_UNFREEZE = 2, 2
# phase 12: per-tau quantile fits as lanes (experiments x levels)
PER_TAU_LEVELS, PER_TAU_SEEDS = (0.1, 0.5, 0.9), 2
# the aggregated results.json of a per-tau experiment (JAX
# st_dadk_tpu/train/experiment.py:201-222)
PER_TAU_KEYS = {"experiment_id", "regression_type", "quantile_levels",
                "quantile_results", "total_time_seconds"} | {
    f"{s}_{m}" for s in ("train", "valid", "test")
    for m in ("crps", "check_loss", "mse", "rmse", "mae")}
# phase 13: the grid {uniform+fixed, kmeans_balanced+learnable} x RAGGED_GRID
GRID_SEEDS = 2
# phase 14: the host libraries of native/ and the exact k-means' resolutions
HOST_LIBS = ("transport", "ingest")
EXACT_KS = (25, 81, 121)
# phase 16: caps of the hash permutation on the card against the CPU
HASH_CAPS = (1, 2, 512, 1000, 8000, 8192)
# phase 17: the bench fit straight against RESUME_AT epochs and a resume
RESUME_EPOCHS, RESUME_AT = 6, 3
# phases 18-20: the competition family (under build/), the epochs each run
# is cut to, the forecast's batch, and the phi shape of the legacy basis
COMPETITION_DIR = "build/chip_smoke_competition"
SUBMIT_EPOCHS, FORECAST_EPOCHS = 12, 20
FORECAST_BATCH = 4096
SUBMIT_BATCH = 4096             # config_st_interp's batch_size
LEGACY_PHI_N = 4096
# JAX's keys of nan_diagnostics.json (st_dadk_tpu/train/experiment.py:415)
NAN_DIAG_KEYS = {"nan_epochs", "n_epochs_run", "train_loss_tail",
                 "val_loss_tail", "inputs", "params"}
# bars: (rtol, atol) of each kernel against its plain version
BARS = {
    "fused_first_layer_fwd": (0.0, 1e-4),       # tests/test_pallas_fused.py:40
    "fused_first_layer_bwd_w": (2e-4, 2e-5),    # tests/test_pallas_fused.py:92
    "fused_first_layer_bwd_centers": (2e-4, 2e-5),
    "fused_first_layer_bwd_points": (2e-4, 2e-5),
    "spatial_basis_fwd": (0.0, 2e-6),           # tests/test_pallas_basis.py:46
    "spatial_basis_bwd_points": (5e-3, 5e-4),   # tests/test_pallas_basis.py:63
    "spatial_basis_bwd_centers": (5e-3, 5e-4),
}
# d yhat / d coords of a fitted model on the card against the plain CPU
# forward's autograd: the basis-gradient bar, for a gradient through the
# whole network
MODEL_GRAD_RTOL, MODEL_GRAD_ATOL = 5e-3, 5e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def _inputs(torch, n, k, h, seed, zero_distance=False):
    """coords, centers, bw, W (k, h), the fused layer's g (N, h) and the
    basis's g (N, k): the gradients of a mean loss, O(1/N) per point."""
    g = torch.Generator().manual_seed(seed)
    coords = torch.rand((n, 2), generator=g)
    centers = torch.rand((k, 2), generator=g)
    if zero_distance:
        m = min(n, k)
        coords[:m] = centers[:m]
    bw = 0.1 + 0.7 * torch.rand((k,), generator=g)
    w = 0.1 * torch.randn((k, h), generator=g)
    grad_h = torch.randn((n, h), generator=g) / n
    grad_phi = torch.randn((n, k), generator=g) / n
    dev = torch.device("cuda")
    return [t.to(dev) for t in (coords, centers, bw, w, grad_h, grad_phi)]


def _err(torch, got, want, rtol, atol):
    """(max abs error, worst |got-want| - (atol + rtol |want|))."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff - atol - rtol * want.abs()).max())


def _outputs(x):
    """A kernel's outputs as a tuple."""
    return x if isinstance(x, tuple) else (x,)


def bound_ms(nm, n, k, h):
    """(least ms the card could take, "bytes" or "operations") for kernel
    `nm` at (n, k, h): each input read once and each output written once at
    the HBM rate, against its operations at their peak rate (the fused
    kernels' product 2 n k h at the 3xTF32 rate and their per-pair chain in
    float32; the basis kernels' per-pair float32 work)."""
    f = 4
    read = f * (2 * n + 3 * k)                 # coords, centers, inv_bw
    nk = n * k
    if nm.startswith("fused_first_layer"):
        product = 2 * n * k * h / TF32X3_FLOPS
        chain = (PHI_OPS if nm.endswith("fwd") or nm.endswith("bwd_w")
                 else DPHI_OPS) * nk / F32_FLOPS
        ops = max(product, chain)
        moved = read + {"fwd": f * k * h + f * n * h,
                        "bwd_w": f * n * h + f * k * h,
                        "bwd_centers": f * k * h + f * n * h + 3 * f * k,
                        "bwd_points": f * k * h + f * n * h + 2 * f * n,
                        }[nm[len("fused_first_layer_"):]]
    else:
        ops = (PHI_OPS if nm.endswith("fwd") else DPHI_OPS) * nk / F32_FLOPS
        moved = read + f * nk + {"fwd": 0, "bwd_points": 2 * f * n,
                                 "bwd_centers": 3 * f * k,
                                 }[nm[len("spatial_basis_"):]]
    t_bytes = moved / HBM_BYTES_S
    return 1e3 * max(ops, t_bytes), ("operations" if ops >= t_bytes
                                     else "bytes")


def _pairs(ffl, sbk, coords, centers, inv_bw, w, grad_h, grad_phi, bid):
    """kernel name -> (kernel call, plain call) on the same inputs."""
    return {
        "fused_first_layer_fwd": (
            lambda: ffl.fused_first_layer_fwd(coords, centers, inv_bw, w, bid),
            lambda: ffl.plain_fwd(coords, centers, inv_bw, w, bid)),
        "fused_first_layer_bwd_w": (
            lambda: ffl.fused_first_layer_bwd_w(coords, centers, inv_bw,
                                                grad_h, bid),
            lambda: ffl.plain_bwd_w(coords, centers, inv_bw, grad_h, bid)),
        "fused_first_layer_bwd_centers": (
            lambda: ffl.fused_first_layer_bwd_centers(coords, centers, inv_bw,
                                                      w, grad_h, bid),
            lambda: ffl.plain_bwd_centers(coords, centers, inv_bw, w, grad_h,
                                          bid)),
        "fused_first_layer_bwd_points": (
            lambda: ffl.fused_first_layer_bwd_points(coords, centers, inv_bw,
                                                     w, grad_h, bid),
            lambda: ffl.plain_bwd_points(coords, centers, inv_bw, w, grad_h,
                                         bid)),
        "spatial_basis_fwd": (
            lambda: sbk.spatial_basis_fwd(coords, centers, inv_bw, bid),
            lambda: sbk.plain_fwd(coords, centers, inv_bw, bid)),
        "spatial_basis_bwd_points": (
            lambda: sbk.spatial_basis_bwd_points(coords, centers, inv_bw,
                                                 grad_phi, bid),
            lambda: sbk.plain_bwd_points(coords, centers, inv_bw, grad_phi,
                                         bid)),
        "spatial_basis_bwd_centers": (
            lambda: sbk.spatial_basis_bwd_centers(coords, centers, inv_bw,
                                                  grad_phi, bid),
            lambda: sbk.plain_bwd_centers(coords, centers, inv_bw, grad_phi,
                                          bid)),
    }


def kernel_phase(torch, ffl, sbk, basis_ids, cal):
    """Check every kernel against its plain version; time both. Returns
    (worst max |d| by kernel, times by (kernel, N), the launch floor)."""
    # create the cuBLAS handle on this thread before autograd's device
    # thread needs one in the plain backward
    torch.ones((2, 2), device="cuda") @ torch.ones((2, 2), device="cuda")
    # basis d coords forms d = sqrt(max(d2, 1e-24)) by its own sequence:
    # it must equal __fsqrt_rn bit for bit, so that r is the plain version's
    bad = sbk.sqrt_check()
    print(f"basis d coords' square root against __fsqrt_rn: {bad} of every "
          f"float in [2^-101, FLT_MAX] differ", flush=True)
    check(bad == 0, f"basis d coords' square root differs from __fsqrt_rn "
          f"for {bad} floats")
    worst = {nm: 0.0 for nm in KERNELS}
    times = {}
    shapes = SLICE_SHAPES + [RAGGED_SHAPE, ODD_SHAPE] + WIDE_K_SHAPES
    cases = ([(s, b, False) for s in shapes for b in basis_ids]
             + [(RAGGED_SHAPE, b, True) for b in basis_ids])
    for i, ((n, k, h), basis, zero) in enumerate(cases):
        coords, centers, bw, w, grad_h, grad_phi = _inputs(
            torch, n, k, h, seed=i, zero_distance=zero)
        inv_bw = (1.0 / (bw * cal[basis])).contiguous()
        pairs = _pairs(ffl, sbk, coords, centers, inv_bw, w, grad_h, grad_phi,
                       basis_ids[basis])
        got = {nm: kern() for nm, (kern, _) in pairs.items()}
        torch.cuda.synchronize()
        line = [f"n={n} k={k} h={h} {basis}{' zero-distance' if zero else ''}:"]
        if (n, k, h) in DETERMINISM_SHAPES:
            for nm in TWO_LAUNCHES:
                again = pairs[nm][0]()
                check(all(torch.equal(a, b) for a, b in
                          zip(_outputs(got[nm]), _outputs(again))),
                      f"{nm}: two launches differ at {line[0]}")
            line.append("fwd, basis d coords and the slab-summing kernels "
                        "bitwise equal over two launches;")
        for nm, (_, plain) in pairs.items():
            want = plain()
            rtol, atol = BARS[nm]
            for a, b in zip(_outputs(got[nm]), _outputs(want)):
                check(bool(torch.isfinite(a).all()),
                      f"{nm}: non-finite output at {line[0]}")
                mx, excess = _err(torch, a, b, rtol, atol)
                worst[nm] = max(worst[nm], mx)
                line.append(f"{nm.replace('first_layer_', '')} "
                            f"max|d|={mx:.3e}")
                check(excess <= 0.0,
                      f"{nm} disagrees with its plain version at {line[0]} "
                      f"(max |d| {mx:.3e}, rtol {rtol}, atol {atol})")
        print("  " + " ".join(line), flush=True)

    from st_dadk_tpu_torch.utils.timing import (GRAPH_REPLAYS, GRAPH_REPS,
                                                events_ms, graph_ms, in_turns)

    # the launch floor: a kernel that does next to nothing, timed as the
    # kernels are; a yardstick for the small-N times, not part of a bound
    one = torch.zeros((1,), device="cuda")
    floor = [graph_ms(lambda: one.add_(1.0)) for _ in range(2)]
    print(f"launch floor: a one-element in-place add, device time a launch "
          f"{floor[0]:.5f} / {floor[1]:.5f} ms (two CUDA-graph replays)",
          flush=True)
    print("kernel times on the card at the fit shapes, Wendland basis: "
          "'eager' = CUDA events around 20 calls (host included), 'device' "
          f"= a CUDA graph of {GRAPH_REPS} calls replayed {GRAPH_REPLAYS} "
          "times (device time a launch); each pair in turns plain, kernel, "
          "kernel, plain; 'bound' = the least time the card could take:")
    for (n, k, h) in SLICE_SHAPES:
        print(f"  N={n}: forward tile {ffl.fwd_tile(n, k, h)}, fused "
              f"bwd_points tile {ffl.bwd_points_tile(n, k, h)}, basis fwd "
              f"plan (points, centers a thread, threads) "
              f"{sbk.basis_fwd_plan(n, k)}, basis bwd_points plan (points, "
              f"threads) {sbk.basis_bwd_points_plan(n, k)}; slabs: fused "
              f"bwd_w {ffl.bwd_w_slabs(n, k, h)}, fused bwd_centers "
              f"{ffl.bwd_centers_slabs(n, k)}, fused bwd_points k-slabs "
              f"{ffl.bwd_points_slabs(n, k, h)}, basis bwd_centers "
              f"{sbk.basis_bwd_centers_slabs(n, k)}", flush=True)
        coords, centers, bw, w, grad_h, grad_phi = _inputs(torch, n, k, h,
                                                           seed=99)
        inv_bw = (1.0 / bw).contiguous()
        pairs = _pairs(ffl, sbk, coords, centers, inv_bw, w, grad_h, grad_phi,
                       basis_ids["wendland"])
        for nm, (kern, plain) in pairs.items():
            t = {key: in_turns(timer, plain, kern)
                 for key, timer in (("eager", events_ms),
                                    ("device", graph_ms))}
            b, by = bound_ms(nm, n, k, h)
            times[(nm, n)] = {"ms": t["device"][0], "plain_ms": t["device"][1],
                              "eager_ms": t["eager"][0],
                              "eager_plain_ms": t["eager"][1],
                              "bound_ms": b, "bound_by": by,
                              "library_ms": None}
            extra = ""
            if nm == "fused_first_layer_fwd":
                # the product alone, on a phi computed beforehand: a
                # yardstick only, the port never calls it
                phi = sbk.plain_fwd(coords, centers, inv_bw,
                                    basis_ids["wendland"])
                lib = graph_ms(lambda: torch.matmul(phi, w))
                times[(nm, n)]["library_ms"] = lib
                extra = f"  library (torch.matmul(phi, w), the product " \
                        f"alone) {lib:.4f} ms"
                del phi
            print(f"  {nm:31s} N={n:6d}: device {t['device'][0]:.4f} ms "
                  f"(plain {t['device'][1]:.4f}), eager {t['eager'][0]:.4f} "
                  f"ms (plain {t['eager'][1]:.4f}), bound {b:.4f} ms "
                  f"({by}, {100 * b / t['device'][0]:.1f} % of device)"
                  + extra, flush=True)
        del coords, centers, bw, w, grad_h, grad_phi, inv_bw, pairs
        torch.cuda.empty_cache()
    return worst, times, floor


def _lane_inputs(torch, lanes, n, k, h, seed):
    """`_inputs` of `lanes` different seeds stacked on a leading lane axis:
    coords (M, n, 2), centers (M, k, 2), bw (M, k), W (M, k, h), g
    (M, n, h)."""
    per_lane = [_inputs(torch, n, k, h, seed=seed + 100 * m)[:5]
                for m in range(lanes)]
    return [torch.stack(ts).contiguous() for ts in zip(*per_lane)]


def _lane_calls(ffl, coords, centers, inv_bw, w, grad_h, bid,
                kernels=LANE_KERNELS):
    """lane kernel name -> (kernel call, plain call) for `kernels`; the
    operands carry a lane axis or not."""
    pairs = _pairs(ffl, None, coords, centers, inv_bw, w, grad_h, None, bid)
    return {nm: pairs[nm] for nm in kernels}


def lane_kernel_phase(torch, ffl, basis_ids, cal, worst):
    """The lane axis of the fused forward, dW and d centers: M fits in one
    launch. Returns {kernel: {M: device ms a launch at the step's shape}}."""
    from st_dadk_tpu_torch.utils.timing import graph_ms

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(_outputs(a), _outputs(b)))

    cases = ([(shape, LANE_KERNELS) for shape in LANE_SHAPES]
             + [(shape, LANE_KERNELS[:1]) for shape in LANE_FWD_SHAPES])
    for ci, ((lanes, n, k, h), kernels) in enumerate(cases):
        for basis in basis_ids:
            coords, centers, bw, w, grad_h = _lane_inputs(
                torch, lanes, n, k, h, seed=1000 + ci)
            inv_bw = (1.0 / (bw * cal[basis])).contiguous()
            bid = basis_ids[basis]
            calls = _lane_calls(ffl, coords, centers, inv_bw, w, grad_h, bid,
                                kernels)
            got = {nm: kern() for nm, (kern, _) in calls.items()}
            torch.cuda.synchronize()
            tile = (f" (the forward alone, tile {ffl.fwd_tile(n, k, h)})"
                    if len(kernels) == 1 else "")
            line = [f"M={lanes} n={n} k={k} h={h} {basis}{tile}:"]
            for nm, (kern, plain) in calls.items():
                want = plain()
                rtol, atol = BARS[nm]
                for a, b in zip(_outputs(got[nm]), _outputs(want)):
                    check(a.shape == b.shape and bool(torch.isfinite(a).all()),
                          f"{nm}: bad lane output at {line[0]}")
                    mx, excess = _err(torch, a, b, rtol, atol)
                    worst[nm] = max(worst[nm], mx)
                    line.append(f"{nm.replace('fused_first_layer_', '')} "
                                f"max|d|={mx:.3e}")
                    check(excess <= 0.0,
                          f"{nm} with lanes disagrees with its plain version "
                          f"at {line[0]} (max |d| {mx:.3e})")
            # a block works inside one lane: lane m of the M-lane launch,
            # and the M = 1 launch, are bitwise the two-dimensional call
            for m in range(lanes):
                ops = [t[m].contiguous() for t in
                       (coords, centers, inv_bw, w, grad_h)]
                flat = _lane_calls(ffl, *ops, bid, kernels)
                one = _lane_calls(ffl, *[t[None] for t in ops], bid, kernels)
                for nm in kernels:
                    two_d = flat[nm][0]()
                    check(same(tuple(o[m] for o in _outputs(got[nm])), two_d),
                          f"{nm}: lane {m} of {lanes} differs from the "
                          f"two-dimensional call at {line[0]}")
                    check(same(tuple(o[0] for o in _outputs(one[nm][0]())),
                               two_d),
                          f"{nm}: the M = 1 call differs from the "
                          f"two-dimensional call at {line[0]}")
            line.append("every lane and M=1 bitwise the 2-D call;")
            if (lanes, n, k, h) == LANE_TWO_LAUNCHES:
                for nm, (kern, _) in calls.items():
                    check(same(got[nm], kern()),
                          f"{nm}: two launches differ at {line[0]}")
                line.append("two launches bitwise equal;")
            print("  " + " ".join(line), flush=True)

    n, k, h = SLICE_SHAPES[0]
    print(f"lane kernels, device time a launch (CUDA-graph replay) at N={n} "
          f"k={k} H={h}, Wendland, beside M times the M = 1 time:")
    lane_ms = {nm: {} for nm in LANE_KERNELS}
    for lanes in LANE_TIMED:
        coords, centers, bw, w, grad_h = _lane_inputs(torch, lanes, n, k, h,
                                                      seed=99)
        calls = _lane_calls(ffl, coords, centers, (1.0 / bw).contiguous(), w,
                            grad_h, basis_ids["wendland"])
        for nm, (kern, _) in calls.items():
            lane_ms[nm][lanes] = (graph_ms(kern) + graph_ms(kern)) / 2
    for nm, by_m in lane_ms.items():
        print(f"  {nm:31s} " + "  ".join(
            f"M={m}: {t:.4f} ms (M x M=1: {m * by_m[1]:.4f})"
            for m, t in by_m.items()), flush=True)
    return lane_ms


def _basis_lane_inputs(torch, lanes, n, k, seed):
    """coords (M, n, 2), centers (M, k, 2), bw (M, k), g (M, n, k) of `lanes`
    seeds, and the column mask (M, k) of MASK_REAL_OF_227's real widths."""
    per_lane = [_inputs(torch, n, k, 1, seed=seed + 100 * m)
                for m in range(lanes)]
    coords, centers, bw, _, _, grad_phi = (
        torch.stack(ts).contiguous() for ts in zip(*per_lane))
    real = [max(1, -(-k * MASK_REAL_OF_227[m % len(MASK_REAL_OF_227)] // 227))
            for m in range(lanes)]
    mask = (torch.arange(k, device="cuda")[None]
            < torch.tensor(real, device="cuda")[:, None]).float()
    return coords, centers, bw, grad_phi, mask, real


def _basis_lane_calls(sbk, coords, centers, inv_bw, grad_phi, bid, mask,
                      kernels=BASIS_LANE_KERNELS):
    calls = {
        "spatial_basis_fwd": (
            lambda: sbk.spatial_basis_fwd(coords, centers, inv_bw, bid, mask),
            lambda: sbk.plain_fwd(coords, centers, inv_bw, bid, mask)),
        "spatial_basis_bwd_centers": (
            lambda: sbk.spatial_basis_bwd_centers(coords, centers, inv_bw,
                                                  grad_phi, bid, mask),
            lambda: sbk.plain_bwd_centers(coords, centers, inv_bw, grad_phi,
                                          bid, mask))}
    return {nm: calls[nm] for nm in kernels}


def basis_lane_kernel_phase(torch, sbk, basis_ids, cal, worst):
    """The lane axis and the per-lane column mask of the basis forward and
    d centers. Returns {kernel: {M: device ms a launch at the step's
    shape, with the mask}}."""
    from st_dadk_tpu_torch.utils.timing import graph_ms

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(_outputs(a), _outputs(b)))

    cases = ([(shape, BASIS_LANE_KERNELS) for shape in LANE_SHAPES]
             + [(shape, BASIS_LANE_KERNELS[:1]) for shape in LANE_FWD_SHAPES])
    for ci, ((lanes, n, k, _), kernels) in enumerate(cases):
        for basis in basis_ids:
            coords, centers, bw, grad_phi, mask, real = _basis_lane_inputs(
                torch, lanes, n, k, seed=2000 + ci)
            inv_bw = (1.0 / (bw * cal[basis])).contiguous()
            bid = basis_ids[basis]
            plan = (f" (the forward alone, plan {sbk.basis_fwd_plan(n, k)})"
                    if len(kernels) == 1 else "")
            line = [f"M={lanes} n={n} k={k} {basis} real widths "
                    f"{real[:4]}{' ...' if lanes > 4 else ''}{plan}:"]
            # the two-dimensional call of every lane, once
            two_d = [_basis_lane_calls(sbk, *[t[m].contiguous() for t in
                                              (coords, centers, inv_bw,
                                               grad_phi)], bid, None, kernels)
                     for m in range(lanes)]
            two_d = [{nm: call[0]() for nm, call in d.items()} for d in two_d]
            for mk, label in ((None, "no mask"), (mask, "mask")):
                calls = _basis_lane_calls(sbk, coords, centers, inv_bw,
                                          grad_phi, bid, mk, kernels)
                got = {nm: kern() for nm, (kern, _) in calls.items()}
                torch.cuda.synchronize()
                for nm, (kern, plain) in calls.items():
                    want = plain()
                    rtol, atol = BARS[nm]
                    for a, b in zip(_outputs(got[nm]), _outputs(want)):
                        check(a.shape == b.shape
                              and bool(torch.isfinite(a).all()),
                              f"{nm}: bad lane output at {line[0]} {label}")
                        mx, excess = _err(torch, a, b, rtol, atol)
                        worst[nm] = max(worst[nm], mx)
                        line.append(f"{nm.replace('spatial_basis_', '')} "
                                    f"({label}) max|d|={mx:.3e}")
                        check(excess <= 0.0,
                              f"{nm} with lanes ({label}) disagrees with its "
                              f"plain version at {line[0]} (max |d| {mx:.3e})")
                    # a block works inside one lane: its real columns are
                    # bitwise the two-dimensional call, its masked ones 0
                    for m in range(lanes):
                        kr = real[m] if mk is not None else k
                        for a, b in zip(_outputs(got[nm]),
                                        _outputs(two_d[m][nm])):
                            # columns: phi's last axis, d centers' first
                            a_m = a[m].movedim(-1, 0) if nm.endswith("fwd") \
                                else a[m]
                            b_m = b.movedim(-1, 0) if nm.endswith("fwd") else b
                            check(torch.equal(a_m[:kr], b_m[:kr]),
                                  f"{nm}: lane {m} of {lanes} ({label}) "
                                  f"differs from the two-dimensional call on "
                                  f"its real columns at {line[0]}")
                            check(bool((a_m[kr:] == 0).all()),
                                  f"{nm}: lane {m} of {lanes} is not exactly "
                                  f"0 on its masked columns at {line[0]}")
                    if (lanes, n, k) == LANE_TWO_LAUNCHES[:3]:
                        check(same(got[nm], kern()),
                              f"{nm}: two launches ({label}) differ at "
                              f"{line[0]}")
            # M = 1 without a mask is the two-dimensional call, bit for bit
            one = _basis_lane_calls(sbk, *[t[:1].contiguous() for t in
                                           (coords, centers, inv_bw,
                                            grad_phi)], bid, None, kernels)
            for nm in kernels:
                check(same(tuple(o[0] for o in _outputs(one[nm][0]())),
                           two_d[0][nm]),
                      f"{nm}: the M = 1 call differs from the "
                      f"two-dimensional call at {line[0]}")
            line.append("every lane bitwise the 2-D call on its real columns "
                        "and 0 on its masked ones, M=1 bitwise the 2-D call;")
            if (lanes, n, k) == LANE_TWO_LAUNCHES[:3]:
                line.append("two launches bitwise equal;")
            print("  " + " ".join(line), flush=True)

    n, k, h = SLICE_SHAPES[0]
    print(f"basis lane kernels with the mask, device time a launch "
          f"(CUDA-graph replay) at N={n} k={k}, Wendland, beside M times the "
          f"M = 1 time and M times the one-lane bound:")
    lane_ms = {nm: {} for nm in BASIS_LANE_KERNELS}
    for lanes in LANE_TIMED:
        coords, centers, bw, grad_phi, mask, _ = _basis_lane_inputs(
            torch, lanes, n, k, seed=99)
        calls = _basis_lane_calls(sbk, coords, centers,
                                  (1.0 / bw).contiguous(), grad_phi,
                                  basis_ids["wendland"], mask)
        for nm, (kern, _) in calls.items():
            lane_ms[nm][lanes] = (graph_ms(kern) + graph_ms(kern)) / 2
    for nm, by_m in lane_ms.items():
        b1 = bound_ms(nm, n, k, h)[0]
        print(f"  {nm:31s} " + "  ".join(
            f"M={m}: {t:.4f} ms (M x M=1: {m * by_m[1]:.4f}, M x bound: "
            f"{m * b1:.5f})" for m, t in by_m.items()), flush=True)
    return lane_ms


def build_all(_build) -> None:
    """One compiler process per library, all started together: nvcc for
    the CUDA sources, g++ for the host libraries of native/."""
    t0 = time.time()
    names = sorted({Path(src).stem for src, _ in KERNELS.values()})
    with ThreadPoolExecutor(len(names) + len(HOST_LIBS)) as pool:
        futures = [pool.submit(_build.build, nm, True) for nm in names]
        futures += [pool.submit(_build.build_host, nm, True)
                    for nm in HOST_LIBS]
        libs = [f.result() for f in futures]
    print(f"built {', '.join(p.name for p in libs)} in "
          f"{time.time() - t0:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true")
    args = ap.parse_args(argv)
    t_start = time.time()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    if not (REPO / "st_dadk_tpu_torch").is_dir():
        print("chip_smoke: st_dadk_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from st_dadk_tpu_torch.ops import _build
    from st_dadk_tpu_torch.ops import fused_first_layer as ffl
    from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
    from st_dadk_tpu_torch.ops.basis import BASIS_IDS, CALIBRATION_FACTORS

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    build_all(_build)
    worst, times, floor = kernel_phase(torch, ffl, sbk, BASIS_IDS,
                                       CALIBRATION_FACTORS)
    lane_ms = lane_kernel_phase(torch, ffl, BASIS_IDS, CALIBRATION_FACTORS,
                                worst)
    lane_ms.update(basis_lane_kernel_phase(torch, sbk, BASIS_IDS,
                                           CALIBRATION_FACTORS, worst))
    launches = {nm: None for nm in KERNELS}
    lane_launches, competition, competition_ms = {}, {}, {}
    if not args.kernels_only:
        phases = Phases(torch, ffl, sbk)
        launches = phases.run()
        lane_launches = phases.lane_launches
        competition = phases.competition_launches
        competition_ms = phases.competition_times
        for nm, err in phases.held_err.items():
            worst[nm] = max(worst[nm], err)

    # ms, plain_ms, bound_ms and library_ms at the training step's shape
    # (device time a launch); "by_n" holds all three fit shapes
    step_n = SLICE_SHAPES[0][0]
    report = {"kernels": [
        {"name": nm, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[nm], "max_abs_err": worst[nm],
         **times[(nm, step_n)], "shape_of_ms": list(SLICE_SHAPES[0]),
         "launch_floor_ms": floor,
         "library_call": ("torch.matmul(phi, w), the product alone on a phi "
                          "computed beforehand"
                          if times[(nm, step_n)]["library_ms"] is not None
                          else None),
         "by_n": {str(n): times[(nm, n)] for n, _, _ in SLICE_SHAPES},
         # the lane axis (five kernels): launches in the LANES-lane fit
         # (fused) or the ragged batch (basis), and device ms a launch by
         # lane count at the step's shape
         "lane_launches": lane_launches.get(nm),
         "lanes_ms": ({str(m): t for m, t in lane_ms[nm].items()}
                      if nm in lane_ms else None),
         # launches in each run of phases 18-20 (the competition path)
         "competition_launches": {run: counts[nm] for run, counts
                                  in competition.items()} or None,
         # device ms a launch at the step shapes of phases 18-19
         "competition_ms": competition_ms.get(nm)}
        for nm, (src, replaces) in KERNELS.items()]}
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all", flush=True)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class Phases:
    """Phases 3-5: the fits and the spatial gradients, each with its own
    launch counts."""

    def __init__(self, torch, ffl, sbk):
        self.torch, self.ffl, self.sbk = torch, ffl, sbk
        self.lane_launches = {}
        self.competition_launches = {}
        self.competition_times = {}
        # kernel -> every launch shape of the counted runs; kernel -> the
        # worst max |d| of the checks at those shapes and in time_shape
        self.launched, self.held_err = {}, {}

    def counted(self, fn):
        """(fn(), launch counts of every kernel during fn)."""
        torch = self.torch
        self.ffl.reset_launch_counts()
        self.sbk.reset_launch_counts()
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        for nm, keys in {**self.ffl.launch_shapes(),
                         **self.sbk.launch_shapes()}.items():
            self.launched.setdefault(nm, set()).update(keys)
        return out, {**self.ffl.launch_counts(), **self.sbk.launch_counts()}

    def run(self):
        from st_dadk_tpu_torch.dataio.synthetic import bench_data_file

        t0 = time.time()
        self.data_file = bench_data_file()
        print(f"data: {self.data_file.relative_to(REPO)} "
              f"({time.time() - t0:.1f} s)", flush=True)
        launches = {}
        bench = self.bench_fit(launches)
        lane = self.ragged_fit(launches)
        unpadded = self.lane_comparison(lane)
        self.spatial_gradients(bench, lane, launches)
        self.lanes_phase(bench)
        jobs = self.ragged_lanes_phase({(tuple(RAGGED_GRID[0]), 1): unpadded,
                                        (tuple(RAGGED_GRID[1]), 1): bench[1]})
        self.pipeline_phase()
        self.init_phase(jobs)
        for name, phase in (("10 (init methods)",
                             lambda: self.init_methods_phase(jobs)),
                            ("11 (Table 4.4)", self.table_phase),
                            ("12 (per-tau lanes)", self.per_tau_phase),
                            ("13 (grid)", self.grid_phase),
                            ("14 (host libraries)",
                             lambda: self.host_phase(jobs)),
                            ("15 (Table 4.4, kmeans_exact)",
                             lambda: self.table_phase("kmeans_exact")),
                            ("16 (hash shuffle)",
                             lambda: self.shuffle_phase(bench)),
                            ("17 (resume, diagnostics, figures)",
                             self.resume_phase),
                            ("18 (competition submission)",
                             self.submission_phase),
                            ("19 (forecast)", self.forecast_phase),
                            ("20 (no hidden layer, analysis)",
                             self.no_hidden_phase),
                            ("21 (every launch shape)",
                             self.launch_shapes_phase)):
            t0 = time.time()
            phase()
            print(f"phase {name}: {time.time() - t0:.1f} s", flush=True)
        return launches

    def fit(self, name, out_dir, exp_id=1, **overrides):
        """One fit of the bench workload through run_single_experiment:
        (results, launch counts, the fit's serving params before finalize)."""
        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.train import experiment as texp

        cfg = bench_workload(data_file=str(self.data_file), epochs=EPOCHS,
                             save_artifacts=True, **overrides)
        print(f"fit ({name}): {EPOCHS} epochs, basis unfreezes at epoch "
              f"{cfg['basis_unfreeze_epoch']}, centers "
              f"{cfg['k_spatial_centers']}"
              + (f" padded to {cfg['k_spatial_pad']}"
                 if cfg.get("k_spatial_pad") else ""), flush=True)
        seen = {}
        finalize = texp.finalize_experiment

        def capture(cfg_, setup, result, *a, **kw):
            seen["params"], seen["model"] = result.params, setup.model
            return finalize(cfg_, setup, result, *a, **kw)

        texp.finalize_experiment = capture
        try:
            res, launches = self.counted(lambda: texp.run_single_experiment(
                cfg, exp_id, out_dir, device="cuda", verbose=exp_id == 1))
        finally:
            texp.finalize_experiment = finalize
        self.report_fit(cfg, res)
        print("launches: " + json.dumps(launches), flush=True)
        return cfg, res, launches, seen

    def report_fit(self, cfg, res):
        import numpy as np

        hist = res["training_history"]
        st = res["stage_timings"]
        print("stage seconds: " + json.dumps({k: round(v, 3) for k, v in
                                              st.items()}), flush=True)
        n_ep, steps = res["n_epochs_run"], res["n_steps"]
        print(f"epochs {n_ep}  steps {steps}  per step "
              f"{1e3 * st['train_steps_seconds'] / steps:.3f} ms  per epoch "
              f"{(st['train_steps_seconds'] + st['validate_seconds']) / n_ep:.3f}"
              f" s (train steps + validation)", flush=True)
        # the first epoch carries the process's first launch of each kernel
        per_epoch = steps // n_ep
        first = st["first_epoch_steps_seconds"]
        rest = st["train_steps_seconds"] - first
        print(f"per step: epoch 1 {1e3 * first / per_epoch:.3f} ms, epochs "
              f"2-{n_ep} {1e3 * rest / (steps - per_epoch):.3f} ms",
              flush=True)
        # repr: every digit, so that two runs' scores compare bitwise
        print(f"test RMSE {res['test_rmse']!r}  test CRPS "
              f"{res['test_crps']!r}  (valid RMSE {res['valid_rmse']!r} "
              f"CRPS {res['valid_crps']!r})", flush=True)
        tl = np.asarray(hist["train_loss"])
        vl = np.asarray(hist["val_loss"])
        check(n_ep == EPOCHS, f"the fit stopped after {n_ep} of {EPOCHS} "
              f"epochs")
        check(bool(np.all(np.isfinite(tl)) and np.all(np.isfinite(vl))),
              "non-finite loss in the history")
        check(tl[-1] < tl[0], f"train loss did not fall: {tl[0]} -> {tl[-1]}")
        shift = np.asarray(res["basis_center_shift"])
        unfreeze = cfg["basis_unfreeze_epoch"]
        check(bool(np.all(shift[:unfreeze] == 0.0)),
              f"centers moved while frozen: {shift[:unfreeze]}")
        check(shift[-1] > 0.0, "centers did not move after the unfreeze epoch")
        check(bool(np.isfinite(res["test_rmse"])
                   and np.isfinite(res["test_crps"])),
              "non-finite test metrics")

    @staticmethod
    def expected_fwd(res):
        """Forward launches of a fit: steps + validations + predict chunks."""
        from st_dadk_tpu_torch.train.loop import n_predict_chunks

        pts = res["n_points"]
        return (res["n_steps"] + res["n_epochs_run"] * res["n_val_chunks"]
                + sum(n_predict_chunks(pts[s]) for s in
                      ("train", "valid", "test", "dense") if pts[s]))

    def bench_fit(self, launches):
        """Phase 3: the bench workload on the fused route (PR 1's path)."""
        import numpy as np

        out_dir = REPO / "build" / "chip_smoke_fit"
        cfg, res, counts, _ = self.fit("bench", out_dir)
        fused = ("fused_first_layer_fwd", "fused_first_layer_bwd_w",
                 "fused_first_layer_bwd_centers")
        for nm in fused:
            check(counts[nm] > 0, f"{nm} was never launched by the fit")
            launches[nm] = counts[nm]
        expect_fwd = self.expected_fwd(res)
        check(counts["fused_first_layer_fwd"] == expect_fwd,
              f"forward launches {counts['fused_first_layer_fwd']} != steps "
              f"+ validations + predict chunks = {expect_fwd}")
        for nm in fused[1:]:
            check(counts[nm] == res["n_steps"], f"{nm} launches {counts[nm]}"
                  f" != steps {res['n_steps']}")
        for nm, c in counts.items():
            if nm not in fused:
                check(c == 0, f"{nm} launched {c} times on the fused route")

        # the dense field the fit predicted through the kernels, against the
        # plain PyTorch forward on the CPU from the saved params
        model, _ = self.saved_model(cfg, out_dir, "cpu")
        dense = np.load(out_dir / "predictions.npz")
        pred = dense["predictions"]
        coords, t_norm, tt, ss = self.grad_points(dense)
        mid = len(cfg["quantile_levels"]) // 2
        from st_dadk_tpu_torch.train.loop import predict
        want = predict(model, coords, t_norm)[:, mid]
        err = float(np.max(np.abs(pred[tt, ss] - want)))
        print(f"dense prediction vs plain CPU forward on {GRAD_POINTS} "
              f"points: max |d| {err:.3e}", flush=True)
        check(err <= 1e-4, f"dense prediction disagrees with the plain CPU "
              f"forward (max |d| {err:.3e} > 1e-4)")
        return cfg, res, out_dir

    def ragged_fit(self, launches):
        """Phase 4: a ragged-k lane through the materialised-phi kernels."""
        import numpy as np

        out_dir = REPO / "build" / "chip_smoke_ragged"
        cfg, res, counts, seen = self.fit(
            "ragged lane", out_dir, k_spatial_centers=LANE_CENTERS,
            k_spatial_pad=LANE_PAD)
        k_real = sum(LANE_CENTERS)
        k_t = sum(cfg["k_temporal_centers"])
        expect_fwd = self.expected_fwd(res)
        check(counts["spatial_basis_fwd"] == expect_fwd,
              f"phi launches {counts['spatial_basis_fwd']} != steps + "
              f"validations + predict chunks = {expect_fwd}")
        check(counts["spatial_basis_bwd_centers"] == res["n_steps"],
              f"spatial_basis_bwd_centers launches "
              f"{counts['spatial_basis_bwd_centers']} != steps "
              f"{res['n_steps']}")
        for nm in ("spatial_basis_fwd", "spatial_basis_bwd_centers"):
            launches[nm] = counts[nm]
        for nm, c in counts.items():
            if nm.startswith("fused_first_layer"):
                check(c == 0, f"{nm} launched {c} times on a ragged lane")

        # the padded rows stay exactly 0: in the serving (EMA) params and in
        # the trained model itself
        trained = {n: p.detach().cpu().numpy()
                   for n, p in seen["model"].named_parameters()}
        serving = seen["params"]
        for where, c, lb, w0 in (
                ("serving", serving["basis"]["centers"],
                 serving["basis"]["log_bandwidths"],
                 serving["mlp"]["linear_0"]["w"]),
                ("trained", trained["basis.centers"],
                 trained["basis.log_bandwidths"],
                 trained["mlp.linear_0.w"])):
            check(c.shape == (LANE_PAD, 2) and w0.shape[0] == LANE_PAD + k_t,
                  f"{where} params are not padded to {LANE_PAD}")
            junk = max(float(np.abs(c[k_real:]).max()),
                       float(np.abs(lb[k_real:]).max()),
                       float(np.abs(w0[k_real:LANE_PAD]).max()))
            check(junk == 0.0, f"{where} padded rows moved: max |x| {junk}")
            check(float(np.abs(w0[:k_real]).max()) > 0.0,
                  f"{where} real rows are zero")
        print(f"padded rows {k_real}..{LANE_PAD - 1}: exactly 0 in the "
              f"serving and the trained params", flush=True)
        info = np.load(out_dir / "basis_info.npz")
        final = np.load(out_dir / "model_final.npz")
        check(info["spatial_centers_final"].shape == (k_real, 2)
              and info["spatial_centers_init"].shape == (k_real, 2),
              f"basis_info carries {info['spatial_centers_final'].shape} "
              f"centers, not {k_real}")
        check(final["mlp.linear_0.w"].shape[0] == k_real + k_t,
              f"model_final carries {final['mlp.linear_0.w'].shape[0]} "
              f"first-layer rows, not {k_real + k_t}")
        return cfg, res, out_dir

    def lane_comparison(self, lane):
        """Phase 4b: the same lane unpadded (fused route, same seed)."""
        _, res_lane, _ = lane
        _, res, counts, _ = self.fit(
            "the lane unpadded", REPO / "build" / "chip_smoke_lane",
            k_spatial_centers=LANE_CENTERS)
        check(counts["fused_first_layer_fwd"] > 0
              and counts["spatial_basis_fwd"] == 0,
              "the unpadded lane did not take the fused route")
        check(res_lane["model_parameters"] == res["model_parameters"],
              f"model_parameters {res_lane['model_parameters']} (ragged) != "
              f"{res['model_parameters']} (unpadded)")
        for key in ("test_rmse", "valid_rmse"):
            d = abs(res_lane[key] - res[key])
            print(f"{key}: ragged lane {res_lane[key]:.6f}  unpadded "
                  f"{res[key]:.6f}  |d| {d:.3e}", flush=True)
            check(d <= LANE_RMSE_BAR, f"{key} of the ragged lane is {d:.3e} "
                  f"from the unpadded lane's (bar {LANE_RMSE_BAR})")
        return res

    def lanes_phase(self, bench):
        """Phase 6: LANES seeds of the bench workload as lanes of one
        batched program, through the runner's engine="vmap"."""
        import csv
        import shutil

        import numpy as np

        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.train.loop import n_predict_chunks
        from st_dadk_tpu_torch.train.runner import (AGG_METRICS,
                                                    QUANTILE_METRICS,
                                                    run_multiple_experiments)

        _, bench_res, _ = bench
        out_dir = REPO / "build" / "chip_smoke_lanes"
        shutil.rmtree(out_dir, ignore_errors=True)
        cfg = bench_workload(data_file=str(self.data_file), epochs=EPOCHS,
                             n_experiments=LANES, save_artifacts=True)
        print(f"lanes phase: {LANES} seeds x {EPOCHS} epochs as lanes of one "
              f"program (engine='vmap')", flush=True)
        t0 = time.time()
        summary, counts = self.counted(lambda: run_multiple_experiments(
            cfg, out_dir, engine="vmap", device="cuda", verbose=True))
        wall = time.time() - t0
        print("launches: " + json.dumps(counts), flush=True)
        check(summary is not None and summary["n_experiments"] == LANES,
              f"the summary holds {summary and summary['n_experiments']} "
              f"experiments, not {LANES}")

        # the results contract of every lane, and the summary files
        results = []
        for i in range(1, LANES + 1):
            exp = out_dir / "experiments" / str(i)
            for f in ("results.json", "training_history.csv",
                      "model_final.npz", "model_best.npz", "predictions.npz",
                      "basis_info.npz"):
                check((exp / f).exists(), f"lane {i}: {f} is missing")
            res = json.loads((exp / "results.json").read_text())
            results.append(res)
            check(res["experiment_id"] == i
                  and res["experiment_seed"] == cfg["base_seed"] + i - 1,
                  f"lane {i}: id {res['experiment_id']} seed "
                  f"{res['experiment_seed']}")
            check(res["n_epochs_run"] == EPOCHS
                  and len(res["training_history"]["train_loss"]) == EPOCHS,
                  f"lane {i} ran {res['n_epochs_run']} of {EPOCHS} epochs")
            hist = res["training_history"]
            check(bool(np.all(np.isfinite(hist["train_loss"]))
                       and np.all(np.isfinite(hist["val_loss"]))),
                  f"lane {i}: non-finite loss in the history")
            check(hist["train_loss"][-1] < hist["train_loss"][0],
                  f"lane {i}: train loss did not fall")
            shift = np.asarray(res["basis_center_shift"])
            unfreeze = cfg["basis_unfreeze_epoch"]
            check(bool(np.all(shift[:unfreeze] == 0.0)) and shift[-1] > 0.0,
                  f"lane {i}: centers moved while frozen or never moved")
            check(bool(np.isfinite(res["test_rmse"])
                       and np.isfinite(res["test_crps"])),
                  f"lane {i}: non-finite test metrics")
            print(f"lane {i} (seed {res['experiment_seed']}): test RMSE "
                  f"{res['test_rmse']!r}  test CRPS {res['test_crps']!r}  "
                  f"(valid RMSE {res['valid_rmse']!r} CRPS "
                  f"{res['valid_crps']!r})", flush=True)
        check(len({r["test_rmse"] for r in results}) == LANES,
              "lanes of different seeds gave equal scores")
        stats = json.loads((out_dir / "summary" /
                            "summary_statistics.json").read_text())
        check(set(stats["statistics"]) == set(AGG_METRICS + QUANTILE_METRICS),
              f"summary statistics hold {sorted(stats['statistics'])}")
        with open(out_dir / "summary" / "all_experiments.csv", newline="") as f:
            rows = list(csv.reader(f))
        check(rows[0] == ["experiment_id", "experiment_seed"] + AGG_METRICS
              + QUANTILE_METRICS and len(rows) == LANES + 1,
              f"all_experiments.csv: header {rows[0]}, {len(rows) - 1} rows")

        # the lanes share launches: one fit's training counts, whatever M
        steps = results[0]["n_steps"]
        check(all(r["n_steps"] == steps for r in results)
              and steps == bench_res["n_steps"],
              f"lane steps {[r['n_steps'] for r in results]} != the single "
              f"fit's {bench_res['n_steps']}")
        dense = results[0]["n_points"]["dense"]
        expect_fwd = (steps + EPOCHS * results[0]["n_val_chunks"]
                      + n_predict_chunks(dense))
        check(counts["fused_first_layer_fwd"] == expect_fwd,
              f"forward launches {counts['fused_first_layer_fwd']} != steps + "
              f"validations + dense predict chunks = {expect_fwd} for "
              f"{LANES} lanes")
        for nm in LANE_KERNELS[1:]:
            check(counts[nm] == steps, f"{nm} launches {counts[nm]} != one "
                  f"fit's steps {steps} for {LANES} lanes")
        for nm, c in counts.items():
            if nm not in LANE_KERNELS:
                check(c == 0, f"{nm} launched {c} times in the lanes phase")
        self.lane_launches = {nm: counts[nm] for nm in LANE_KERNELS}

        st = results[0]["stage_timings"]
        B = int(st["steps_per_epoch_batch"])
        later = ((st["epochs_seconds"] - st["first_epoch_seconds"])
                 / ((EPOCHS - 1) * B))
        print(f"batch of {LANES} lanes: setup {st['batch_setup_seconds']:.3f} "
              f"s (init a lane {st['init_seconds']:.3f} s), epochs "
              f"{st['epochs_seconds']:.3f} s, finalize eval "
              f"{st['batch_eval_seconds']:.3f} s, wall {wall:.3f} s; a step "
              f"(validation included) in epochs 2-{EPOCHS}: "
              f"{1e3 * later:.3f} ms = {1e3 * later / LANES:.3f} ms a lane; "
              f"{3600.0 * LANES / wall:.1f} {EPOCHS}-epoch fits an hour "
              f"at this width, set-up and finalize included", flush=True)

        # lane 0 against the single fit of its seed: dropout 0, no shuffle;
        # on the bench schedule, and with the basis training from step 1
        quiet = dict(cfg, dropout=0.0, shuffle="none", save_artifacts=False)
        self.lane_pair("bench schedule", quiet, drift=True)
        self.lane_pair(f"basis unfrozen, {LANE_EARLY_EPOCHS} epochs",
                       dict(quiet, basis_unfreeze_epoch=0,
                            epochs=LANE_EARLY_EPOCHS), drift=False)

    def lane_pair(self, name, quiet, drift, lane_jobs=None):
        """LANES lanes of config `quiet` (no dropout, no shuffling; or the
        batch `lane_jobs`, whose lane 0 is `quiet`, through `run_job_batch`)
        and the single fit of lane 0's seed: loss histories within
        LANE_EARLY_RTOL
        in the first LANE_EARLY_EPOCHS epochs. With `drift` the later epochs
        and the scores are held to LANE_DRIFT_FACTOR times what a one-ulp
        change of W_s does to the single fit; without it the run ends after
        the early epochs, the centers must have moved, and lane 0's scores
        are held to LANE_SCORE_RTOL."""
        import shutil

        import numpy as np

        from st_dadk_tpu_torch.config import ExperimentConfig
        from st_dadk_tpu_torch.train import loop
        from st_dadk_tpu_torch.train.experiment import (ExperimentSetup,
                                                        run_single_experiment)
        from st_dadk_tpu_torch.train.batch_engine import run_job_batch
        from st_dadk_tpu_torch.train.runner import run_multiple_experiments

        pair_dir = REPO / "build" / "chip_smoke_lanes_pair"
        shutil.rmtree(pair_dir, ignore_errors=True)
        if lane_jobs is None:
            run_multiple_experiments(quiet, pair_dir / "lanes", engine="vmap",
                                     device="cuda")
        else:
            run_job_batch([(c, i, pair_dir / "lanes" / "experiments" / str(n))
                           for n, (c, i) in enumerate(lane_jobs, start=1)],
                          device="cuda")
        lane0 = json.loads((pair_dir / "lanes" / "experiments" / "1" /
                            "results.json").read_text())
        single = run_single_experiment(quiet, 1, pair_dir / "single",
                                       device="cuda", verbose=False)
        n_ep = single["n_epochs_run"]
        check(lane0["n_epochs_run"] == n_ep == quiet["epochs"],
              f"{name}: lane 0 ran {lane0['n_epochs_run']} epochs, its single "
              f"fit {n_ep}, of {quiet['epochs']}")
        score_bar = LANE_SCORE_RTOL
        drifts = {}
        if drift:
            # the same single fit with W_s one ulp up: what rounding alone does
            quiet_cfg = ExperimentConfig.from_dict(quiet)
            setup = ExperimentSetup(quiet_cfg, 1, "cuda")
            with self.torch.no_grad():
                w = setup.model.mlp.linear_0.w
                w.copy_(self.torch.nextafter(w, self.torch.full_like(w, 10.0)))
            nudged = loop.fit(quiet_cfg, setup.spec, setup.model,
                              setup.train_ps, setup.valid_ps,
                              seed=setup.experiment_seed)
        else:
            shift = (np.asarray(lane0["basis_center_shift"]),
                     np.asarray(single["basis_center_shift"]))
            check(shift[0][0] > 0.0 and shift[1][0] > 0.0,
                  f"{name}: the centers did not move in epoch 1")
            gap = float((np.abs(shift[0] - shift[1]) / shift[1]).max())
            print(f"lane 0 vs its single fit ({name}), center shift by epoch: "
                  f"relative gap {gap:.1e}", flush=True)
            check(gap <= LANE_EARLY_RTOL, f"{name}: lane 0's centers are "
                  f"{gap:.3e} from its single fit's (bar {LANE_EARLY_RTOL})")
        for key in ("train_loss", "val_loss"):
            a = np.asarray(lane0["training_history"][key])
            b = np.asarray(single["training_history"][key])
            gaps = np.abs(a - b) / np.abs(b)
            early = float(gaps[:LANE_EARLY_EPOCHS].max())
            print(f"lane 0 vs its single fit ({name}; dropout 0, shuffle "
                  f"none), {key}, relative gap by epoch: "
                  + " ".join(f"{g:.1e}" for g in gaps), flush=True)
            check(early <= LANE_EARLY_RTOL,
                  f"{name}: lane 0's {key} is {early:.3e} from its single "
                  f"fit's in epochs 1-{LANE_EARLY_EPOCHS} (bar "
                  f"{LANE_EARLY_RTOL})")
            if not drift:
                continue
            drifts[key] = np.abs(np.asarray(nudged.history[key]) - b) / np.abs(b)
            bar = np.maximum(LANE_EARLY_RTOL, LANE_DRIFT_FACTOR
                             * np.maximum.accumulate(drifts[key]))
            print(f"  the single fit with W_s one ulp up: "
                  + " ".join(f"{g:.1e}" for g in drifts[key]) + "; bar: "
                  + " ".join(f"{g:.1e}" for g in bar), flush=True)
            over = np.maximum.accumulate(gaps) > bar
            check(not over.any(),
                  f"{name}: lane 0's {key} drifts from its single fit further "
                  f"than {LANE_DRIFT_FACTOR} x a one-ulp change of W_s does, "
                  f"from epoch {int(np.argmax(over)) + 1}")
        if drift:
            score_bar = max(LANE_SCORE_RTOL, LANE_DRIFT_FACTOR * max(
                float(d.max()) for d in drifts.values()))
        for key in LANE_SCORES:
            gap = abs(lane0[key] - single[key]) / abs(single[key])
            print(f"lane 0 vs its single fit ({name}), {key}: "
                  f"{lane0[key]!r} / {single[key]!r}  relative gap {gap:.1e} "
                  f"(bar {score_bar:.1e})", flush=True)
            check(gap <= score_bar, f"{name}: lane 0's {key} is {gap:.3e} "
                  f"from its single fit's (bar {score_bar:.1e})")

    def ragged_jobs(self, out_dir, ids, **overrides):
        """(config, experiment id, output dir) of RAGGED_GRID x `ids`, both
        resolutions padded to LANE_PAD: lanes of one program."""
        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.config import ExperimentConfig

        jobs = []
        for kl in RAGGED_GRID:
            cfg = ExperimentConfig.from_dict(bench_workload(
                data_file=str(self.data_file), epochs=EPOCHS,
                k_spatial_centers=list(kl), k_spatial_pad=LANE_PAD,
                save_artifacts=True, **overrides))
            jobs += [(cfg, i, out_dir / f"k{sum(kl)}_{i}") for i in ids]
        return jobs

    def ragged_lanes_phase(self, single_fits):
        """Phase 7: RAGGED_GRID x RAGGED_IDS as ragged-k lanes of one
        program through `run_job_batch`. `single_fits` holds the unpadded
        single fits earlier phases ran, by (resolutions, experiment id)."""
        import shutil

        import numpy as np

        from st_dadk_tpu_torch.train import batch_engine as tbe
        from st_dadk_tpu_torch.train.loop import n_predict_chunks

        out_dir = REPO / "build" / "chip_smoke_ragged_lanes"
        shutil.rmtree(out_dir, ignore_errors=True)
        jobs = self.ragged_jobs(out_dir, RAGGED_IDS)
        M = len(jobs)
        print(f"ragged-lanes phase: centers {list(RAGGED_GRID)} padded to "
              f"{LANE_PAD} x experiments {list(RAGGED_IDS)} = {M} lanes of "
              f"one program (run_job_batch), {EPOCHS} epochs", flush=True)
        seen = {}
        finalize = tbe._finalize_job_batch

        def capture(state):
            seen["state"] = state
            return finalize(state)

        tbe._finalize_job_batch = capture
        t0 = time.time()
        try:
            results, counts = self.counted(
                lambda: tbe.run_job_batch(jobs, device="cuda", verbose=True))
        finally:
            tbe._finalize_job_batch = finalize
        wall = time.time() - t0
        print("launches: " + json.dumps(counts), flush=True)
        check(len(results) == M, f"{len(results)} results for {M} lanes")

        # launches: one fit's, whatever M; nothing on the fused route
        steps = results[0]["n_steps"]
        dense = results[0]["n_points"]["dense"]
        expect_fwd = (steps + EPOCHS * results[0]["n_val_chunks"]
                      + n_predict_chunks(dense))
        check(all(r["n_steps"] == steps for r in results),
              f"lane steps {[r['n_steps'] for r in results]}")
        check(counts["spatial_basis_fwd"] == expect_fwd,
              f"phi launches {counts['spatial_basis_fwd']} != steps + "
              f"validations + dense predict chunks = {expect_fwd} for {M} "
              f"lanes")
        check(counts["spatial_basis_bwd_centers"] == steps,
              f"basis d centers launches "
              f"{counts['spatial_basis_bwd_centers']} != one fit's steps "
              f"{steps} for {M} lanes")
        for nm, c in counts.items():
            if nm not in BASIS_LANE_KERNELS:
                check(c == 0, f"{nm} launched {c} times in a ragged batch")
        self.lane_launches.update({nm: counts[nm]
                                   for nm in BASIS_LANE_KERNELS})

        # junk rows exactly 0 after training: the trained lanes and the
        # serving (EMA) params, a lane each at its own real width
        state = seen["state"]
        trained = {n: p.detach().cpu().numpy()
                   for n, p in state["lanes_model"].named_parameters()}
        k_t = sum(jobs[0][0].k_temporal_centers)
        for li, (cfg, exp_id, lane_dir) in enumerate(jobs):
            k_real = sum(cfg.k_spatial_centers)
            serving = state["results"][li].params
            for where, c, lb, w0 in (
                    ("serving", serving["basis"]["centers"],
                     serving["basis"]["log_bandwidths"],
                     serving["mlp"]["linear_0"]["w"]),
                    ("trained", trained["basis.centers"][li],
                     trained["basis.log_bandwidths"][li],
                     trained["mlp.linear_0.w"][li])):
                check(c.shape == (LANE_PAD, 2)
                      and w0.shape[0] == LANE_PAD + k_t,
                      f"lane {li}: {where} params are not padded to "
                      f"{LANE_PAD}")
                junk = max([float(np.abs(x).max()) for x in
                            (c[k_real:], lb[k_real:], w0[k_real:LANE_PAD])
                            if x.size] or [0.0])
                check(junk == 0.0, f"lane {li}: {where} padded rows moved: "
                      f"max |x| {junk}")
                check(float(np.abs(w0[:k_real]).max()) > 0.0,
                      f"lane {li}: {where} real rows are zero")

            # the results contract, at the lane's real shapes
            res = results[li]
            for f in ("results.json", "training_history.csv",
                      "model_final.npz", "model_best.npz", "predictions.npz",
                      "basis_info.npz"):
                check((lane_dir / f).exists(), f"lane {li}: {f} is missing")
            on_disk = json.loads((lane_dir / "results.json").read_text())
            check(on_disk["experiment_id"] == exp_id
                  and on_disk["test_rmse"] == res["test_rmse"]
                  and on_disk["config"]["k_spatial_centers"]
                  == list(cfg.k_spatial_centers),
                  f"lane {li}: results.json is not this lane's")
            check(res["n_epochs_run"] == EPOCHS
                  and len(res["training_history"]["train_loss"]) == EPOCHS,
                  f"lane {li} ran {res['n_epochs_run']} of {EPOCHS} epochs")
            hist = res["training_history"]
            check(bool(np.all(np.isfinite(hist["train_loss"]))
                       and np.all(np.isfinite(hist["val_loss"])))
                  and hist["train_loss"][-1] < hist["train_loss"][0],
                  f"lane {li}: losses not finite or not falling")
            shift = np.asarray(res["basis_center_shift"])
            unfreeze = cfg.basis_unfreeze_epoch
            check(bool(np.all(shift[:unfreeze] == 0.0)) and shift[-1] > 0.0,
                  f"lane {li}: centers moved while frozen or never moved")
            info = np.load(lane_dir / "basis_info.npz")
            final = np.load(lane_dir / "model_final.npz")
            check(info["spatial_centers_final"].shape == (k_real, 2)
                  and info["spatial_centers_init"].shape == (k_real, 2)
                  and final["mlp.linear_0.w"].shape[0] == k_real + k_t,
                  f"lane {li}: artifacts do not carry the real {k_real} "
                  f"centers")

            # against the lane's own unpadded single fit (the fused route)
            key = (tuple(cfg.k_spatial_centers), exp_id)
            if key not in single_fits:
                _, single_fits[key], _, _ = self.fit(
                    f"lane {li} unpadded, experiment {exp_id}",
                    REPO / "build" / "chip_smoke_lane_single", exp_id=exp_id,
                    k_spatial_centers=list(cfg.k_spatial_centers))
            single = single_fits[key]
            check(res["model_parameters"] == single["model_parameters"],
                  f"lane {li}: model_parameters {res['model_parameters']} != "
                  f"the unpadded fit's {single['model_parameters']}")
            gaps = {k: abs(res[k] - single[k]) for k in ("test_rmse",
                                                         "valid_rmse")}
            print(f"lane {li} (centers {list(cfg.k_spatial_centers)}, seed "
                  f"{res['experiment_seed']}, {res['model_parameters']} "
                  f"parameters): test RMSE {res['test_rmse']!r} valid RMSE "
                  f"{res['valid_rmse']!r} CRPS {res['test_crps']!r}; |d| to "
                  f"its unpadded single fit: test {gaps['test_rmse']:.3e} "
                  f"valid {gaps['valid_rmse']:.3e}", flush=True)
            for k, d in gaps.items():
                check(d <= LANE_STREAM_BAR, f"lane {li}: {k} is {d:.3e} from "
                      f"its unpadded single fit's (bar {LANE_STREAM_BAR})")
        check(len({r["test_rmse"] for r in results}) == M,
              "ragged lanes gave equal scores")

        st = results[0]["stage_timings"]
        B = int(st["steps_per_epoch_batch"])
        later = ((st["epochs_seconds"] - st["first_epoch_seconds"])
                 / ((EPOCHS - 1) * B))
        print(f"ragged batch of {M} lanes: host set-up "
              f"{st['batch_prepare_seconds']:.3f} s, init and models "
              f"{st['batch_init_seconds']:.3f} s (init a lane "
              f"{st['init_seconds']:.3f} s), epochs "
              f"{st['epochs_seconds']:.3f} s, finalize "
              f"{st['batch_finalize_seconds']:.3f} s (evaluation "
              f"{st['batch_eval_seconds']:.3f} s), wall {wall:.3f} s; a step "
              f"(validation included) in epochs 2-{EPOCHS}: "
              f"{1e3 * later:.3f} ms = {1e3 * later / M:.3f} ms a lane",
              flush=True)

        # lane 0 against the single padded-lane fit of its config (phase 4's
        # path): dropout 0, no shuffle
        quiet_jobs = [(c.replace(dropout=0.0, save_artifacts=False,
                                 extra=dict(c.extra, shuffle="none")), i)
                      for c, i, _ in jobs]
        self.lane_pair("ragged lanes, bench schedule",
                       quiet_jobs[0][0].to_dict(), drift=True,
                       lane_jobs=quiet_jobs)
        self.ragged_quiet_lanes(quiet_jobs)
        return jobs

    def ragged_quiet_lanes(self, quiet_jobs):
        """Every ragged lane against its own unpadded single fit where the
        two share their streams: dropout 0, no shuffle, RAGGED_QUIET_EPOCHS
        epochs with the basis training from the first step. The three RMSEs
        within RAGGED_QUIET_BAR."""
        import shutil

        from st_dadk_tpu_torch.train.batch_engine import run_job_batch
        from st_dadk_tpu_torch.train.experiment import run_single_experiment

        out_dir = REPO / "build" / "chip_smoke_ragged_quiet"
        shutil.rmtree(out_dir, ignore_errors=True)
        jobs = [(c.replace(epochs=RAGGED_QUIET_EPOCHS, basis_unfreeze_epoch=0),
                 i, out_dir / f"lane{n}") for n, (c, i) in
                enumerate(quiet_jobs)]
        lanes = run_job_batch(jobs, device="cuda")
        for li, ((cfg, exp_id, _), res) in enumerate(zip(jobs, lanes)):
            single = run_single_experiment(
                cfg.replace(k_spatial_pad=None), exp_id,
                out_dir / f"single{li}", device="cuda", verbose=False)
            check(res["basis_center_shift"][0] > 0.0,
                  f"lane {li}: the centers did not move in epoch 1")
            gaps = {k: abs(res[k] - single[k]) for k in
                    ("test_rmse", "valid_rmse", "train_rmse")}
            print(f"ragged lane {li} (centers {list(cfg.k_spatial_centers)}, "
                  f"experiment {exp_id}) vs its unpadded single fit, dropout "
                  f"0, shuffle none, {RAGGED_QUIET_EPOCHS} epochs, basis "
                  f"unfrozen: |d| test RMSE {gaps['test_rmse']:.3e} valid "
                  f"{gaps['valid_rmse']:.3e} train {gaps['train_rmse']:.3e}",
                  flush=True)
            for k, d in gaps.items():
                check(d <= RAGGED_QUIET_BAR, f"ragged lane {li}: {k} is "
                      f"{d:.3e} from its unpadded single fit's (bar "
                      f"{RAGGED_QUIET_BAR})")

    def pipeline_phase(self):
        """Phase 8: PIPELINE_JOBS jobs of the ragged grid at PIPELINE_WIDTH
        lanes a batch: through `run_lane_jobs` (the threaded pipeline) and as
        batches one after another, in turns serial, pipelined, pipelined,
        serial. Results must be bitwise equal."""
        import shutil

        import numpy as np

        from st_dadk_tpu_torch.train import batch_engine as tbe

        root = REPO / "build" / "chip_smoke_pipeline"
        shutil.rmtree(root, ignore_errors=True)
        ids = range(1, PIPELINE_JOBS // len(RAGGED_GRID) + 1)
        compared = ("experiment_id", "experiment_seed", "metrics",
                    "training_history", "n_steps", "basis_center_shift",
                    "model_parameters")

        def run(name, pipelined):
            jobs = self.ragged_jobs(root / name, ids,
                                    lanes_per_device=PIPELINE_WIDTH)
            # one lane of each resolution a batch
            jobs = [jobs[j * len(ids) + i] for i in range(len(ids))
                    for j in range(len(RAGGED_GRID))]
            self.torch.cuda.synchronize()
            t0 = time.time()
            if pipelined:
                res = tbe.run_lane_jobs(jobs, jobs[0][0], device="cuda")
            else:
                res = []
                for a in range(0, len(jobs), PIPELINE_WIDTH):
                    res += tbe.run_job_batch(jobs[a:a + PIPELINE_WIDTH],
                                             device="cuda")
            self.torch.cuda.synchronize()
            wall = time.time() - t0
            st = [r["stage_timings"] for r in res[::PIPELINE_WIDTH]]
            print(f"  {name}: wall {wall:.3f} s; a batch (host set-up, init "
                  f"and models, train, finalize) seconds: " + "; ".join(
                      f"{t['batch_prepare_seconds']:.3f} "
                      f"{t['batch_init_seconds']:.3f} "
                      f"{t['batch_train_seconds']:.3f} "
                      f"{t['batch_finalize_seconds']:.3f}" for t in st),
                  flush=True)
            return jobs, res, wall

        print(f"pipeline phase: {PIPELINE_JOBS} jobs of the ragged grid, "
              f"{PIPELINE_WIDTH} lanes a batch, {EPOCHS} epochs: "
              f"run_lane_jobs (prepare and finalize threads) against "
              f"run_job_batch one batch after another", flush=True)
        runs = [run(name, piped) for name, piped in (
            ("serial_1", False), ("pipelined_1", True),
            ("pipelined_2", True), ("serial_2", False))]
        ref_jobs, ref, _ = runs[0]
        check([r["experiment_id"] for r in ref]
              == [i for i in ids for _ in RAGGED_GRID],
              "the serial run's results are out of order")
        for jobs, res, _ in runs[1:]:
            check(len(res) == len(ref), f"{len(res)} results, not {len(ref)}")
            for (_, _, d0), r0, (_, _, d1), r1 in zip(ref_jobs, ref, jobs,
                                                      res):
                for key in compared:
                    check(r0[key] == r1[key], f"pipeline phase: {key} of "
                          f"{d1.name} differs from {d0.parent.name}'s")
                a, b = (np.load(d / "model_final.npz") for d in (d0, d1))
                check(set(a.files) == set(b.files) and all(
                    np.array_equal(a[f], b[f]) for f in a.files),
                    f"pipeline phase: saved params of {d1} differ")
        serial = (runs[0][2] + runs[3][2]) / 2
        piped = (runs[1][2] + runs[2][2]) / 2
        print(f"pipelined and serial results bitwise equal; wall pipelined "
              f"{piped:.3f} s, serial {serial:.3f} s (means of two): "
              f"{piped / serial:.3f} of serial", flush=True)

    def init_streams(self, setups, i):
        """Lane i's init streams as its setup left them: a fresh generator
        and a copy of its numpy stream."""
        import copy

        s = setups[i]
        return (self.torch.Generator(device="cuda").manual_seed(
            s.experiment_seed), copy.deepcopy(s.np_rng))

    def init_lanes(self, method, setups, groups, batched):
        """Every lane's spatial init, each from `init_streams`: (the
        (centers, bandwidths) of each lane, the init's stats of each lane
        (lane by lane) or of each group of `groups` (batched, one call a
        group), seconds a lane)."""
        from st_dadk_tpu_torch.ops import init_centers as ic

        out = [None] * len(setups)
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        if batched:
            stats = {}
            for klist, idx in groups.items():
                gens, rngs = zip(*[self.init_streams(setups, i) for i in idx])
                for i, pair in zip(idx, ic.init_spatial_centers_batch(
                        method, list(klist),
                        [setups[i].train_ps.coords for i in idx], gens, rngs,
                        "cuda", stats=stats.setdefault(klist, {}))):
                    out[i] = pair
        else:
            stats = []
            for i, s in enumerate(setups):
                gen, rng = self.init_streams(setups, i)
                stats.append({})
                out[i] = ic.init_spatial_centers(
                    method, s.cfg.k_spatial_centers, s.train_ps.coords,
                    generator=gen, device="cuda", rng=rng, stats=stats[-1])
        self.torch.cuda.synchronize()
        return out, stats, (time.perf_counter() - t0) / len(setups)

    @staticmethod
    def init_setups(jobs):
        """The host set-up of `jobs` and its lanes by resolution list."""
        from st_dadk_tpu_torch.train import batch_engine as tbe

        setups = tbe._prepare_job_batch(jobs, device="cuda")["setups"]
        groups = {}
        for i, s in enumerate(setups):
            groups.setdefault(tuple(s.cfg.k_spatial_centers), []).append(i)
        return setups, groups

    def init_phase(self, jobs):
        """Phase 9: the batched GMM init of the ragged lanes against the
        lane-by-lane init, each lane from the streams its setup left."""
        import numpy as np

        from st_dadk_tpu_torch.ops import init_centers as ic

        setups, groups = self.init_setups(jobs)

        def lane_by_lane():
            return self.init_lanes("gmm", setups, groups, batched=False)

        def batched():
            return self.init_lanes("gmm", setups, groups, batched=True)

        lane_by_lane(), batched()                           # warm-up
        runs = [lane_by_lane(), batched(), batched(), lane_by_lane()]
        (one, one_stats, _), (bat, bat_stats, _) = runs[0], runs[1]
        self.gmm_seconds = ((runs[0][2] + runs[3][2]) / 2,
                            (runs[1][2] + runs[2][2]) / 2)
        seed_s = sum(st["seed_seconds"] for st in one_stats) / len(setups)
        em_s = sum(st["em_seconds"] for st in one_stats) / len(setups)
        n_pts = min(len(setups[0].train_ps.coords), 10000)
        print(f"GMM init of the {len(setups)} ragged lanes ({n_pts:,} points "
              f"a lane, 3 restarts a resolution): lane by lane "
              f"{runs[0][2]:.3f} / {runs[3][2]:.3f} s a lane (k-means++ "
              f"seeding {seed_s:.3f} s, EM {em_s:.3f} s); batched {runs[1][2]:.3f} / {runs[2][2]:.3f} s a "
              f"lane (seeding " + ", ".join(
                  f"{st['seed_seconds'] / len(groups[kl]):.3f}" for kl, st in
                  bat_stats.items()) + " s, EM " + ", ".join(
                  f"{st['em_seconds'] / len(groups[kl]):.3f}" for kl, st in
                  bat_stats.items()) + " s a lane by group)", flush=True)
        worst_c = worst_b = 0.0
        for klist, idx in groups.items():
            iters_b = np.concatenate(bat_stats[klist]["em_iterations"], axis=1)
            for row, i in enumerate(idx):
                dc = float(np.abs(one[i][0] - bat[i][0]).max())
                db = float(np.abs(one[i][1] - bat[i][1]).max())
                worst_c, worst_b = max(worst_c, dc), max(worst_b, db)
                iters_1 = np.concatenate(one_stats[i]["em_iterations"],
                                         axis=1)[0].tolist()
                print(f"  lane {i} (centers {list(klist)}): max |d centers| "
                      f"{dc:.3e}  max |d bandwidths| {db:.3e}  EM iterations "
                      f"lane by lane {iters_1} batched "
                      f"{iters_b[row].tolist()}", flush=True)
                check(list(iters_1) == iters_b[row].tolist(),
                      f"lane {i}: the batched EM took other iteration counts")
                check(bool(np.all(np.isfinite(bat[i][0]))
                           and np.all(bat[i][1] > 0)),
                      f"lane {i}: bad batched init")
        check(max(worst_c, worst_b) <= INIT_BATCH_ATOL,
              f"the batched init is {worst_c:.3e} (centers) / {worst_b:.3e} "
              f"(bandwidths) from the lane-by-lane init (bar "
              f"{INIT_BATCH_ATOL})")

        # lanes of two subsample sizes in one call: each bitwise its own init
        klist = list(RAGGED_GRID[0])
        cut = [s.train_ps.coords[:None if i % 2 == 0 else UNEQUAL_INIT_POINTS]
               for i, s in enumerate(setups)]
        gens, rngs = zip(*[self.init_streams(setups, i)
                           for i in range(len(setups))])
        mixed = ic.init_spatial_centers_batch("gmm", klist, cut, gens, rngs,
                                              "cuda")
        for i, (c, b) in enumerate(mixed):
            gen, rng = self.init_streams(setups, i)
            c1, b1 = ic.init_spatial_centers("gmm", klist, cut[i],
                                             generator=gen, device="cuda",
                                             rng=rng)
            check(bool(np.array_equal(c, c1) and np.array_equal(b, b1)),
                  f"lane {i} of a batch with subsamples of "
                  f"{sorted({min(len(x), 10000) for x in cut})} points is "
                  f"{np.abs(c - c1).max():.3e} from its own init")
        print(f"  lanes with subsamples of "
              f"{[min(len(x), 10000) for x in cut]} points in one call: each "
              f"bitwise its own init", flush=True)

    def init_methods_phase(self, jobs):
        """Phase 10: 'random_site' and 'kmeans_balanced' for the ragged
        lanes, batched against lane by lane, each lane from the streams its
        setup left: random sites bitwise, balanced k-means with the same
        restart kept and centers within KMB_BATCH_RTOL / KMB_BATCH_ATOL."""
        import numpy as np

        setups, groups = self.init_setups(jobs)

        def best(stats, i):
            """Lane i's kept restarts, a resolution each."""
            if isinstance(stats, list):
                return [int(b[0]) for b in stats[i].get("best_restart", [])]
            klist = tuple(setups[i].cfg.k_spatial_centers)
            row = groups[klist].index(i)
            return [int(b[row]) for b in stats[klist].get("best_restart", [])]

        def lane_by_lane(method):
            out, stats, secs = self.init_lanes(method, setups, groups, False)
            return out, [best(stats, i) for i in range(len(setups))], secs

        def batched(method):
            out, stats, secs = self.init_lanes(method, setups, groups, True)
            return out, [best(stats, i) for i in range(len(setups))], secs

        secs = {}
        for method in ("random_site", "kmeans_balanced"):
            batched(method)          # warm-up: the ops a lane alone runs too
            runs = [lane_by_lane(method), batched(method), batched(method),
                    lane_by_lane(method)]
            (one, best1, _), (bat, bestb, _) = runs[0], runs[1]
            secs[method] = ((runs[0][2] + runs[3][2]) / 2,
                            (runs[1][2] + runs[2][2]) / 2)
            worst_c = worst_b = 0.0
            for i in range(len(setups)):
                dc = float(np.abs(one[i][0] - bat[i][0]).max())
                db = float(np.abs(one[i][1] - bat[i][1]).max())
                worst_c, worst_b = max(worst_c, dc), max(worst_b, db)
                check(bool(np.all(np.isfinite(bat[i][0]))
                           and np.all(bat[i][1] > 0)),
                      f"{method} lane {i}: bad batched init")
                if method == "random_site":
                    check(bool(np.array_equal(one[i][0], bat[i][0])
                               and np.array_equal(one[i][1], bat[i][1])),
                          f"random_site lane {i}: the batched sites are "
                          f"{dc:.3e} from the lane's own")
                    continue
                print(f"  kmeans_balanced lane {i} (centers "
                      f"{list(setups[i].cfg.k_spatial_centers)}): restarts "
                      f"kept lane by lane {best1[i]} batched {bestb[i]}; max "
                      f"|d centers| {dc:.3e}  max |d bandwidths| {db:.3e}",
                      flush=True)
                check(best1[i] == bestb[i], f"kmeans_balanced lane {i}: the "
                      f"batch kept restarts {bestb[i]}, the lane alone "
                      f"{best1[i]}")
                check(bool(np.allclose(bat[i][0], one[i][0],
                                       rtol=KMB_BATCH_RTOL,
                                       atol=KMB_BATCH_ATOL)),
                      f"kmeans_balanced lane {i}: batched centers {dc:.3e} "
                      f"from the lane's own (rtol {KMB_BATCH_RTOL}, atol "
                      f"{KMB_BATCH_ATOL})")
            print(f"{method} init of the {len(setups)} ragged lanes: max |d| "
                  f"batched vs lane by lane: centers {worst_c:.3e}, "
                  f"bandwidths {worst_b:.3e} (bitwise: "
                  f"{worst_c == worst_b == 0.0})", flush=True)
        print("init seconds a lane, lane by lane / batched (means of two): "
              + "; ".join(f"{m} {a:.4f} / {b:.4f}" for m, (a, b) in
                          list(secs.items())
                          + [("gmm (phase 9)", self.gmm_seconds)]),
              flush=True)

    def table_phase(self, da_init=None):
        """Phase 11: Table 4.4 through `cli/run_table_4_4.py`'s `main` on the
        repo's config file (the 'tpu' device name and the YAML reader run
        here), TABLE_SEEDS seeds x EPOCHS epochs a cell, engine vmap: 8 finite
        CRPS values, STDK's centers the uniform grid after training, DA-STDK's
        centers moved in training and lane 1's initial centers its balanced
        k-means alone, on the fused route only. Phase 15 (`da_init`
        'kmeans_exact', the CLI's --da_stdk_init_method): each DA-STDK
        lane's init seconds, and lane 1's initial centers in each DA-STDK
        cell bitwise its exact k-means alone (phase 14 and the CPU tests
        hold the solver; this shows the CLI hands a lane its stream)."""
        import shutil

        import numpy as np

        from st_dadk_tpu_torch.cli import run_table_4_4 as t44
        from st_dadk_tpu_torch.config import ExperimentConfig
        from st_dadk_tpu_torch.ops.basis import uniform_grid_centers
        from st_dadk_tpu_torch.ops.init_centers import init_spatial_centers
        from st_dadk_tpu_torch.train.experiment import ExperimentSetup

        out_dir = REPO / "build" / ("chip_smoke_table_4_4"
                                    + (f"_{da_init}" if da_init else ""))
        shutil.rmtree(out_dir, ignore_errors=True)
        argv = ["--config", str(REPO / "configs" / "config_st_interp.yaml"),
                "--data_file", str(self.data_file),
                "--n_experiments", str(TABLE_SEEDS), "--engine", "vmap",
                "--overrides", json.dumps({"epochs": EPOCHS,
                                           "basis_unfreeze_epoch":
                                           TABLE_UNFREEZE}),
                "--output_dir", str(out_dir)]
        if da_init:
            argv += ["--da_stdk_init_method", da_init]
        print("Table 4.4 phase: python3 -m st_dadk_tpu_torch.cli.run_table_4_4 "
              + " ".join(argv), flush=True)
        _, counts = self.counted(lambda: t44.main(argv))
        print("launches: " + json.dumps(counts), flush=True)
        summary = json.loads((out_dir / "table_4_4_summary.json").read_text())
        cells = {k: v for k, v in summary.items() if not k.startswith("_")}
        check(len(cells) == 8 and all(
            e["n"] == TABLE_SEEDS and np.isfinite(e["test_crps_mean"])
            for e in cells.values()),
            f"table_4_4_summary.json: {json.dumps(cells)}")
        fused = ("fused_first_layer_fwd", "fused_first_layer_bwd_w",
                 "fused_first_layer_bwd_centers")
        for nm, c in counts.items():
            check(c > 0 if nm in fused else c == 0,
                  f"{nm} launched {c} times in the Table 4.4 phase")

        def exact_alone(cfg, i):
            """Lane i's exact k-means alone, from its setup's streams."""
            setup = ExperimentSetup(cfg, i, "cuda", defer_model=True)
            return init_spatial_centers(da_init, cfg.k_spatial_centers,
                                        setup.train_ps.coords,
                                        rng=setup.np_rng)[0]

        # the lane-1 exact k-means run on threads: the native solver and
        # numpy's large ops release the GIL
        pool, exact = ThreadPoolExecutor(4), []
        for scenario, model in (k.split("/") for k in cells):
            cdir = out_dir / f"table4.4_{scenario}_{model}"
            cfg = ExperimentConfig.from_yaml(cdir / "config.yaml")
            check(cfg.device == "tpu", f"{cdir.name}: device {cfg.device!r}")
            grid = uniform_grid_centers(cfg.k_spatial_centers)[0]
            for i in range(1, TABLE_SEEDS + 1):
                info = np.load(cdir / "experiments" / str(i) / "basis_info.npz")
                init = info["spatial_centers_init"]
                final = info["spatial_centers_final"]
                moved = float(np.abs(final - init).max())
                if model == "STDK":
                    check(bool(np.array_equal(init, grid)
                               and np.array_equal(final, grid)),
                          f"{cdir.name} lane {i}: centers are not the uniform "
                          f"grid (moved {moved:.3e})")
                    continue
                check(moved > 0.0, f"{cdir.name} lane {i}: the centers did "
                      f"not move in training")
                if da_init == "kmeans_exact":
                    check(cfg.spatial_init_method == da_init,
                          f"{cdir.name}: init {cfg.spatial_init_method!r}")
                    st = json.loads((cdir / "experiments" / str(i)
                                     / "results.json").read_text()
                                    )["stage_timings"]
                    print(f"  {cdir.name} lane {i}: exact k-means init "
                          f"{st['init_seconds']:.4f} s a lane (the batch's "
                          f"{st['batch_init_seconds']:.4f} s over its "
                          f"{st['batch_lanes']} lanes)", flush=True)
                    if i == 1:
                        exact.append((cdir.name, i, init, moved,
                                      pool.submit(exact_alone, cfg, i)))
                    continue
                if i > 1:
                    continue     # lane 1's init alone, for time; phase 10
                                 # holds every lane of a batch
                setup = ExperimentSetup(cfg, i, "cuda", defer_model=True)
                want, _ = init_spatial_centers(
                    "kmeans_balanced", cfg.k_spatial_centers,
                    setup.train_ps.coords,
                    generator=self.torch.Generator(device="cuda").manual_seed(
                        setup.experiment_seed),
                    device="cuda", rng=setup.np_rng)
                d = float(np.abs(init - want).max())
                print(f"  {cdir.name} lane {i}: initial centers vs its "
                      f"balanced k-means alone max |d| {d:.3e}; moved "
                      f"{moved:.3e} in training", flush=True)
                check(bool(np.allclose(init, want, rtol=KMB_BATCH_RTOL,
                                       atol=KMB_BATCH_ATOL)),
                      f"{cdir.name} lane {i}: initial centers {d:.3e} from "
                      f"its balanced k-means")
        for name, i, init, moved, want in exact:
            want = want.result()
            d = float(np.abs(init - want).max())
            print(f"  {name} lane {i}: initial centers vs its exact k-means "
                  f"alone max |d| {d:.3e}; moved {moved:.3e} in training",
                  flush=True)
            check(bool(np.array_equal(init, want)), f"{name} lane {i}: "
                  f"initial centers {d:.3e} from its exact k-means alone")
        pool.shutdown()

    def per_tau_phase(self):
        """Phase 12: the bench workload as per-tau quantile fits,
        PER_TAU_SEEDS experiments x PER_TAU_LEVELS as lanes through the
        runner's engine 'vmap': the quantile_<q>/ trees and the aggregated
        results.json; then lane (first seed, tau 0.5) of a quiet 3-epoch run
        (dropout 0, no shuffling, basis unfrozen; three taus, so tau is lane
        data) against its single fit: losses at LANE_EARLY_RTOL, the center
        shift at it in epoch 1 and by phase 6's drift rule after."""
        import shutil

        import numpy as np

        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.config import ExperimentConfig
        from st_dadk_tpu_torch.train import loop
        from st_dadk_tpu_torch.train.experiment import (ExperimentSetup,
                                                        run_single_experiment)
        from st_dadk_tpu_torch.train.runner import run_multiple_experiments

        out_dir = REPO / "build" / "chip_smoke_per_tau"
        shutil.rmtree(out_dir, ignore_errors=True)
        levels = list(PER_TAU_LEVELS)
        cfg = bench_workload(data_file=str(self.data_file), epochs=EPOCHS,
                             n_experiments=PER_TAU_SEEDS,
                             regression_type="quantile",
                             quantile_levels=levels)
        print(f"per-tau phase: {PER_TAU_SEEDS} experiments x taus {levels} "
              f"= {PER_TAU_SEEDS * len(levels)} lanes, {EPOCHS} epochs",
              flush=True)
        summary, counts = self.counted(lambda: run_multiple_experiments(
            cfg, out_dir / "lanes", engine="vmap", device="cuda"))
        print("launches: " + json.dumps(counts), flush=True)
        for nm, c in counts.items():
            check(c > 0 if nm in LANE_KERNELS else c == 0,
                  f"{nm} launched {c} times in the per-tau phase")
        check(summary is not None
              and summary["n_experiments"] == PER_TAU_SEEDS
              and "test_crps" in summary["statistics"],
              "per-tau summary: no test_crps statistics")
        for i in range(1, PER_TAU_SEEDS + 1):
            exp = out_dir / "lanes" / "experiments" / str(i)
            for q in levels:
                qd = exp / f"quantile_{q}"
                for f in ("results.json", "training_history.csv",
                          "predictions.npz", "basis_info.npz",
                          "model_final.npz"):
                    check((qd / f).exists(), f"per-tau {i}: {qd.name}/{f} is "
                          f"missing")
                r = json.loads((qd / "results.json").read_text())
                check(r["quantile_level"] == q and r["n_epochs_run"] == EPOCHS
                      and np.isfinite(r["test_check_loss"]),
                      f"per-tau {i}: {qd.name}/results.json")
            agg = json.loads((exp / "results.json").read_text())
            check(set(agg) == PER_TAU_KEYS and agg["quantile_levels"] == levels
                  and np.isfinite(agg["test_crps"])
                  and agg["test_rmse"] == float(np.sqrt(agg["test_mse"])),
                  f"per-tau {i}: aggregated results.json keys "
                  f"{sorted(set(agg) ^ PER_TAU_KEYS)} differ")
            print(f"experiment {i}: test CRPS over the tau models "
                  f"{agg['test_crps']!r}, mean check loss "
                  f"{agg['test_check_loss']!r}", flush=True)

        quiet = dict(cfg, dropout=0.0, shuffle="none", save_artifacts=False,
                     epochs=LANE_EARLY_EPOCHS, basis_unfreeze_epoch=0)
        run_multiple_experiments(quiet, out_dir / "quiet", engine="vmap",
                                 device="cuda")
        lane = json.loads((out_dir / "quiet" / "experiments" / "1" /
                           "quantile_0.5" / "results.json").read_text())
        single = run_single_experiment(
            dict(quiet, quantile_levels=[0.5]), 1, out_dir / "single",
            device="cuda", verbose=False)
        check(single["quantile_level"] == 0.5, "the single fit is not tau 0.5")
        for key in ("train_loss", "val_loss"):
            a = np.asarray(lane["training_history"][key])
            b = np.asarray(single["training_history"][key])
            gap = float((np.abs(a - b) / np.abs(b)).max())
            print(f"per-tau lane (seed {lane['experiment_seed']}, tau 0.5) vs "
                  f"its single fit, {key}: relative gap {gap:.1e}", flush=True)
            check(a.shape == b.shape and gap <= LANE_EARLY_RTOL,
                  f"per-tau lane: {key} {gap:.3e} from its single fit's (bar "
                  f"{LANE_EARLY_RTOL})")
        # the centers: under one tau's check loss a residual's sign flips
        # with its last bit, so the lane's center path may drift from its
        # single fit's as far as rounding alone moves it: LANE_DRIFT_FACTOR
        # x what W_s one ulp up does to the single fit (phase 6's rule)
        cfg1 = ExperimentConfig.from_dict(dict(quiet, quantile_levels=[0.5]))
        setup = ExperimentSetup(cfg1, 1, "cuda")
        with self.torch.no_grad():
            w = setup.model.mlp.linear_0.w
            w.copy_(self.torch.nextafter(w, self.torch.full_like(w, 10.0)))
        nudged = loop.fit(cfg1.replace(current_quantile=0.5), setup.spec,
                          setup.model, setup.train_ps, setup.valid_ps,
                          seed=setup.experiment_seed)
        a, b = (np.asarray(lane["basis_center_shift"]),
                np.asarray(single["basis_center_shift"]))
        gap = np.abs(a - b) / b
        bar = np.maximum(LANE_EARLY_RTOL, LANE_DRIFT_FACTOR * np.maximum.
                         accumulate(np.abs(nudged.center_shift - b) / b))
        print("per-tau lane vs its single fit, center shift by epoch: "
              "relative gap " + " ".join(f"{g:.1e}" for g in gap)
              + "; bar (10 x the one-ulp drift) "
              + " ".join(f"{g:.1e}" for g in bar), flush=True)
        check(b[0] > 0.0 and gap[0] <= LANE_EARLY_RTOL
              and not (np.maximum.accumulate(gap) > bar).any(),
              f"per-tau lane: center shift {a} vs its single fit's {b}")

    def grid_phase(self):
        """Phase 13: `run_grid_search` over {uniform+fixed,
        kmeans_balanced+learnable} x RAGGED_GRID, GRID_SEEDS seeds, engine
        vmap: the four CSV/JSON files, one summary a config, each bucket a
        ragged batch padded to LANE_PAD on the phi route with its junk rows
        exactly 0."""
        import csv
        import shutil

        import numpy as np

        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.cli.run_grid_search import config_filter
        from st_dadk_tpu_torch.sweep.grid import run_grid_search
        from st_dadk_tpu_torch.train import batch_engine as tbe

        out_dir = REPO / "build" / "chip_smoke_grid"
        shutil.rmtree(out_dir, ignore_errors=True)
        base = bench_workload(data_file=str(self.data_file), epochs=EPOCHS,
                              n_experiments=GRID_SEEDS, save_artifacts=True)
        param_grid = {"spatial_init_method": ["uniform", "kmeans_balanced"],
                      "spatial_learnable": [True, False],
                      "k_spatial_centers": [list(k) for k in RAGGED_GRID]}
        states = []
        finalize = tbe._finalize_job_batch
        tbe._finalize_job_batch = lambda st: states.append(st) or finalize(st)
        try:
            results, counts = self.counted(lambda: run_grid_search(
                base, param_grid, out_dir, filter_fn=config_filter,
                engine="vmap", device="cuda"))
        finally:
            tbe._finalize_job_batch = finalize
        print("grid phase: " + ", ".join(r["config"]["tag"] for r in results)
              + "; launches: " + json.dumps(counts), flush=True)
        check(len(results) == 4 and all(r["status"] == "success"
                                        for r in results),
              f"grid: {[(r['config']['tag'], r['status']) for r in results]}")
        for f in ("grid_search_summary.csv", "grid_search_detail.csv",
                  "grid_search_configs.json", "grid_search_configs.csv"):
            check((out_dir / f).exists(), f"grid: {f} is missing")
        with open(out_dir / "grid_search_summary.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == 4 and all(np.isfinite(float(r["test_crps_mean"]))
                                     for r in rows),
              f"grid_search_summary.csv holds {len(rows)} rows")
        with open(out_dir / "grid_search_detail.csv", newline="") as f:
            check(len(list(csv.DictReader(f))) == 4 * GRID_SEEDS,
                  "grid_search_detail.csv: not one row a fit")
        for r in results:
            st = json.loads((out_dir / r["config"]["tag"] / "summary" /
                             "summary_statistics.json").read_text())
            check(st["n_experiments"] == GRID_SEEDS,
                  f"{r['config']['tag']}: summary of {st['n_experiments']}")
        for nm in BASIS_LANE_KERNELS:
            check(counts[nm] > 0, f"{nm} was never launched by the grid")
        for nm, c in counts.items():
            if nm.startswith("fused_first_layer"):
                check(c == 0, f"{nm} launched {c} times in ragged buckets")
        check(len(states) == 2 and all(len(st["setups"]) == 2 * GRID_SEEDS
                                       for st in states),
              f"grid: {len(states)} batches, not one a bucket of "
              f"{2 * GRID_SEEDS} lanes")
        k_t = sum(base["k_temporal_centers"])
        for st in states:
            trained = {n: p.detach().cpu().numpy()
                       for n, p in st["lanes_model"].named_parameters()}
            for li, s in enumerate(st["setups"]):
                check(s.cfg.k_spatial_pad == LANE_PAD,
                      f"grid lane {li}: padded to {s.cfg.k_spatial_pad}")
                k_real = sum(s.cfg.k_spatial_centers)
                serving = st["results"][li].params
                # a fixed basis has no centers among its params
                for where, c, w0 in (
                        ("serving", serving.get("basis", {}).get("centers"),
                         serving["mlp"]["linear_0"]["w"]),
                        ("trained", trained.get("basis.centers"),
                         trained["mlp.linear_0.w"][li])):
                    if c is not None and c.ndim == 3:
                        c = c[li]
                    check(w0.shape[0] == LANE_PAD + k_t and (
                        c is None or c.shape == (LANE_PAD, 2)),
                          f"grid lane {li}: {where} params not padded")
                    junk = max([float(np.abs(x).max()) for x in
                                (w0[k_real:LANE_PAD],
                                 None if c is None else c[k_real:])
                                if x is not None and x.size] or [0.0])
                    check(junk == 0.0, f"grid lane {li} ({s.cfg.tag}): "
                          f"{where} padded rows moved: max |x| {junk}")
        print(f"grid: {len(states)} ragged buckets of {2 * GRID_SEEDS} lanes "
              f"padded to {LANE_PAD}; junk rows exactly 0", flush=True)

    def host_phase(self, jobs):
        """Phase 14: the host libraries built from native/ (build_all):
        the exact k-means of phase 7's lane 0 subsample (the float64 draw
        its init makes) with the native transport solver against the LP:
        bitwise where k < the distinct sites; at every k, one assignment at
        each run's final centers solved both ways at equal cost. The
        stand-in CSV through the native loader against the numpy reader,
        bitwise."""
        import copy

        import numpy as np

        from st_dadk_tpu_torch.dataio.kaust import read_kaust_csv
        from st_dadk_tpu_torch.dataio.native import load_csv_native
        from st_dadk_tpu_torch.ops import _build
        from st_dadk_tpu_torch.ops.init_centers import _subsample
        from st_dadk_tpu_torch.ops.kmeans_exact import (balanced_caps,
                                                        kmeans_constrained,
                                                        transport_assign,
                                                        transport_assign_native)

        for nm in HOST_LIBS:
            path = _build.host_library_path(nm)
            check(path.exists(), f"host library {path.name} was not built")
        setups, _ = self.init_setups(jobs)
        s = setups[0]
        X = np.asarray(_subsample(s.train_ps.coords, None,
                                  copy.deepcopy(s.np_rng)), np.float64)
        sites, counts = np.unique(X, axis=0, return_counts=True)
        n_sites = len(sites)
        for k in EXACT_KS:
            t0 = time.perf_counter()
            cn, ln = kmeans_constrained(X, k)
            t1 = time.perf_counter()
            cl, ll = kmeans_constrained(X, k, solver="lp")
            t2 = time.perf_counter()
            d = float(np.abs(cn - cl).max())
            inertia = [float(((X - c[lab]) ** 2).sum())
                       for c, lab in ((cn, ln), (cl, ll))]
            gaps = []
            for c in (cn, cl):
                cost = ((sites[:, None] - c[None]) ** 2).sum(-1)
                caps = balanced_caps(len(X), k)
                plans = (transport_assign_native(cost, counts, caps)[0],
                         transport_assign(cost, counts, caps)[0])
                a, b = (float((p * cost).sum()) for p in plans)
                gaps.append(abs(a - b) / b)
            print(f"  exact k-means, {len(X)} points on {n_sites} sites, "
                  f"k={k}: native {t1 - t0:.4f} s, LP {t2 - t1:.4f} s; max "
                  f"|d centers| {d:.3e}, labels equal "
                  f"{bool(np.array_equal(ln, ll))}, inertia native "
                  f"{inertia[0]!r} LP {inertia[1]!r}; one assignment at "
                  f"either run's centers: relative cost gap "
                  f"{max(gaps):.3e}", flush=True)
            check(max(gaps) <= 1e-12, f"exact k-means k={k}: the native "
                  f"plan's cost is {max(gaps):.3e} from the LP's")
            if k < n_sites:
                check(bool(np.array_equal(cn, cl)
                           and np.array_equal(ln, ll)),
                      f"exact k-means k={k}: the native solver's centers "
                      f"are {d:.3e} from the LP's")
        t0 = time.perf_counter()
        z_n, c_n, rows_n = load_csv_native(self.data_file)
        t1 = time.perf_counter()
        z_p, c_p, rows_p = read_kaust_csv(self.data_file)
        t2 = time.perf_counter()
        print(f"  stand-in CSV ({rows_n} rows): native {t1 - t0:.4f} s, "
              f"numpy {t2 - t1:.4f} s", flush=True)
        check(bool(rows_n == rows_p and np.array_equal(c_n, c_p)
                   and np.array_equal(z_n, z_p, equal_nan=True)),
              "the native CSV loader and the numpy reader disagree")

    def shuffle_phase(self, bench):
        """Phase 16: the hash permutation on the card against the CPU's for
        the same multipliers, a row alone and as a lane axis; then the bench
        fit under 'perm' beside phase 3's under the default 'auto'."""
        torch = self.torch
        from st_dadk_tpu_torch.train import loop as tl

        for cap in HASH_CAPS:
            g = torch.Generator().manual_seed(cap)
            r = torch.randint(0, tl.hash_width(cap), (4, 4), generator=g)
            cpu = tl.hash_permutation_any(r, cap)
            gpu = tl.hash_permutation_any(r.cuda(), cap).cpu()
            check(torch.equal(gpu, cpu), f"hash permutation, cap {cap}: "
                  f"the card's differs from the CPU's")
            check(torch.equal(tl.hash_permutation_any(r[1].cuda(), cap).cpu(),
                              cpu[1]), f"hash permutation, cap {cap}: a lane "
                  f"differs from its row alone")
            check(bool((torch.sort(cpu, dim=1).values
                        == torch.arange(cap)).all()),
                  f"hash permutation, cap {cap}: not a permutation")
        print(f"hash permutation: caps {list(HASH_CAPS)}, 4 lanes each: the "
              f"card's bitwise the CPU's, each a permutation", flush=True)
        _, perm, _, _ = self.fit("bench, shuffle perm",
                                 REPO / "build" / "chip_smoke_fit_perm",
                                 shuffle="perm")
        auto = bench[1]
        for key in ("test_rmse", "test_crps", "valid_rmse", "valid_crps"):
            print(f"  bench fit {key}: shuffle auto {auto[key]!r}, perm "
                  f"{perm[key]!r}", flush=True)

    def resume_phase(self):
        """Phase 17: the bench fit RESUME_EPOCHS epochs straight against
        RESUME_AT epochs into a checkpoint and a resume, bitwise; the NaN
        diagnostics of a fit whose LR overflows the weights; a fit with
        save_plots on."""
        import contextlib
        import importlib.util
        import io
        import shutil

        import numpy as np

        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.config import ExperimentConfig
        from st_dadk_tpu_torch.train import experiment as texp
        from st_dadk_tpu_torch.train import loop as tl

        cfg = ExperimentConfig.from_dict(bench_workload(
            data_file=str(self.data_file), epochs=RESUME_EPOCHS))

        def run(**kw):
            s = texp.ExperimentSetup(cfg, 1, "cuda")
            return tl.fit(cfg, s.spec, s.model, s.train_ps, s.valid_ps,
                          seed=s.experiment_seed, epochs_chunk=RESUME_AT,
                          **kw)

        ckpt = REPO / "build" / "chip_smoke_resume.npz"
        ckpt.unlink(missing_ok=True)
        t0 = time.time()
        straight = run()
        part = run(checkpoint_path=ckpt, session_epochs=RESUME_AT)
        resumed = run(checkpoint_path=ckpt, resume=True)
        check(part.n_epochs_run == RESUME_AT
              and resumed.n_epochs_run == straight.n_epochs_run
              == RESUME_EPOCHS, f"resume: epochs {part.n_epochs_run} / "
              f"{resumed.n_epochs_run} / {straight.n_epochs_run}")
        same = all(np.array_equal(straight.history[k], resumed.history[k])
                   for k in ("train_loss", "val_loss", "val_rmse"))
        flat = texp._flatten_params
        for tree in ("params", "final_ema"):
            a, b = flat(getattr(straight, tree)), flat(getattr(resumed, tree))
            same = same and all(np.array_equal(a[k], b[k]) for k in a)
        print(f"resume: {RESUME_EPOCHS} epochs straight against {RESUME_AT} "
              f"+ resume: bitwise {same} (train loss "
              f"{straight.history['train_loss'][-1]!r} / "
              f"{resumed.history['train_loss'][-1]!r}); "
              f"{time.time() - t0:.1f} s", flush=True)
        check(same, "the resumed bench fit differs from the straight one")

        out = REPO / "build" / "chip_smoke_nan"
        shutil.rmtree(out, ignore_errors=True)
        texp.run_single_experiment(bench_workload(
            data_file=str(self.data_file), epochs=2, lr=1e38), 1, out,
            device="cuda", verbose=False)
        diag = json.loads((out / "nan_diagnostics.json").read_text())
        check(set(diag) == NAN_DIAG_KEYS and diag["nan_epochs"] == [0, 1],
              f"nan_diagnostics.json: keys {sorted(diag)}, NaN epochs "
              f"{diag.get('nan_epochs')}")
        print(f"NaN fit: nan_diagnostics.json with JAX's keys, NaN epochs "
              f"{diag['nan_epochs']}", flush=True)

        out = REPO / "build" / "chip_smoke_plots"
        shutil.rmtree(out, ignore_errors=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = texp.run_single_experiment(bench_workload(
                data_file=str(self.data_file), epochs=2, save_plots=True,
                save_artifacts=True), 1, out, device="cuda", verbose=False)
        pngs = sorted(p.name for p in out.glob("*.png"))
        if importlib.util.find_spec("matplotlib") is None:
            warned = "[WARNING] plotting failed" in buf.getvalue()
            check(warned and not pngs, f"save_plots without matplotlib: "
                  f"warning {warned}, figures {pngs}")
        else:
            check(len(pngs) == 7, f"save_plots: figures {pngs}")
        check(bool(np.isfinite(res["test_crps"])),
              "save_plots fit: non-finite test CRPS")
        print(f"save_plots fit: completed, figures {pngs or 'none'}; "
              + buf.getvalue().strip().replace("\n", " | "), flush=True)

    def competition_family(self):
        """The family of phases 18-19 (2a's layout), cut from the stand-in
        field once a run."""
        from st_dadk_tpu_torch.dataio.competition import \
            write_competition_family

        if getattr(self, "family", None) is None:
            import shutil
            shutil.rmtree(REPO / COMPETITION_DIR, ignore_errors=True)
            self.family = write_competition_family(self.data_file,
                                                   REPO / COMPETITION_DIR)
        return self.family

    def hold(self, nm, kern, plain, where):
        """One call of kernel `nm` against its plain version at BARS[nm]:
        fails on a non-finite output or on excess; keeps the worst max |d|
        for the result line."""
        torch = self.torch
        rtol, atol = BARS[nm]
        got, want = kern(), plain()
        worst = 0.0
        for a, b in zip(_outputs(got), _outputs(want)):
            check(bool(torch.isfinite(a).all()),
                  f"{nm}: non-finite output at {where}")
            mx, excess = _err(torch, a, b, rtol, atol)
            worst = max(worst, mx)
            check(excess <= 0.0,
                  f"{nm} disagrees with its plain version at {where} (max "
                  f"|d| {mx:.3e}, rtol {rtol}, atol {atol})")
        self.held_err[nm] = max(self.held_err.get(nm, 0.0), worst)
        return worst

    def launch_shapes_phase(self):
        """Phase 21: each kernel against its plain version at every shape
        (N, k, H, basis) that a counted run of phases 3-20 launched it at
        without a lane axis or a column mask, on seeded inputs; the lane
        phases hold the lane axis and the mask."""
        from st_dadk_tpu_torch.ops.basis import BASIS_IDS, CALIBRATION_FACTORS

        torch = self.torch
        basis_names = {v: nm for nm, v in BASIS_IDS.items()}
        for nm in KERNELS:
            keys = sorted(self.launched.get(nm, ()))
            flat = [key for key in keys if not key[0] and not key[4]]
            worst, shapes = 0.0, []
            for i, (_, n, k, h, _, bid) in enumerate(flat):
                coords, centers, bw, w, grad_h, grad_phi = _inputs(
                    torch, n, k, max(h, 1), seed=300 + i)
                basis = basis_names[bid]
                inv_bw = 1.0 / (bw * CALIBRATION_FACTORS[basis])
                kern, plain = _pairs(self.ffl, self.sbk, coords, centers,
                                     inv_bw.contiguous(), w, grad_h,
                                     grad_phi, bid)[nm]
                where = f"launch shape N={n} k={k} H={h} {basis}"
                worst = max(worst, self.hold(nm, kern, plain, where))
                shapes.append(f"{n}x{k}" + (f"x{h}" if h else "")
                              + ("" if basis == "wendland" else f" {basis}"))
            print(f"  {nm}: held at {len(flat)} launch shapes ("
                  + ", ".join(shapes) + f"), worst max |d| {worst:.3e} "
                  f"(rtol, atol {BARS[nm]}); {len(keys) - len(flat)} more "
                  "with a lane axis or a mask", flush=True)

    def time_shape(self, names, n, k, h, tag):
        """Each kernel in `names` against its plain version at (n, k, h),
        Wendland; then device ms a launch of both, CUDA-graph replays in
        turns, beside its bound; kept for the result line."""
        from st_dadk_tpu_torch.ops.basis import BASIS_IDS
        from st_dadk_tpu_torch.utils.timing import graph_ms, in_turns

        coords, centers, bw, w, grad_h, grad_phi = _inputs(self.torch, n, k,
                                                           h, seed=98)
        pairs = _pairs(self.ffl, self.sbk, coords, centers,
                       (1.0 / bw).contiguous(), w, grad_h, grad_phi,
                       BASIS_IDS["wendland"])
        for nm in names:
            self.hold(nm, *pairs[nm], f"{tag} N={n} k={k} H={h}")
            ms, plain_ms = in_turns(graph_ms, *pairs[nm][::-1])
            b, by = bound_ms(nm, n, k, h)
            self.competition_times.setdefault(nm, {})[
                f"{tag} N={n} k={k} H={h}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                "bound_by": by}
            print(f"  {nm:31s} {tag} N={n} k={k}: device {ms:.4f} ms "
                  f"(plain {plain_ms:.4f}), bound {b:.4f} ms ({by}, "
                  f"{100 * b / ms:.1f} % of device)", flush=True)

    def _submission(self, name, main, argv):
        """Run a submission CLI's `main` counted; check one finite value a
        test row, on disk as returned; (summary, launch counts)."""
        import numpy as np

        from st_dadk_tpu_torch.dataio.kaust import read_columns

        fam = self.competition_family()
        print(f"{name}: python3 -m st_dadk_tpu_torch.cli.{name} "
              + " ".join(argv), flush=True)
        summary, counts = self.counted(lambda: main(argv))
        z = summary["z_hat"]
        n_test = len(read_columns(fam["test"])["t"])
        written = read_columns(summary["out"])["z"]
        check(len(z) == n_test and len(written) == n_test,
              f"{name}: {len(z)} values ({len(written)} written) for "
              f"{n_test} test rows")
        check(bool(np.all(np.isfinite(z))), f"{name}: non-finite values")
        check(bool(np.array_equal(written, z)),
              f"{name}: the written submission differs from its values")
        check("rmse" in summary, f"{name}: no score against the solutions")
        self.competition_launches[name] = counts
        return summary, counts, n_test

    def submission_phase(self):
        """Phase 18: `cli/predict_submission` on the stand-in family at full
        width (configs/config_st_interp.yaml), SUBMIT_EPOCHS epochs."""
        from st_dadk_tpu_torch.cli import predict_submission as ps

        fam = self.competition_family()
        argv = ["--family", str(fam["stem"]),
                "--config", str(REPO / "configs" / "config_st_interp.yaml"),
                "--epochs", str(SUBMIT_EPOCHS),
                "--out", str(fam["stem"].parent / "submission.csv")]
        summary, counts, n_test = self._submission("predict_submission",
                                                   ps.main, argv)
        fused = ("fused_first_layer_fwd", "fused_first_layer_bwd_w",
                 "fused_first_layer_bwd_centers")
        print(f"predict_submission: {n_test} rows, RMSE {summary['rmse']!r} "
              f"MAE {summary['mae']!r}, {summary['n_epochs_run']} epochs in "
              f"{summary['train_seconds']:.1f} s; launches "
              + json.dumps({k: v for k, v in counts.items() if v}),
              flush=True)
        for nm in fused:
            check(counts[nm] > 0, f"predict_submission: {nm} never launched")
        for nm in ("spatial_basis_fwd", "spatial_basis_bwd_centers",
                   "spatial_basis_bwd_points", "fused_first_layer_bwd_points"):
            check(counts[nm] == 0, f"predict_submission: {nm} launched "
                  f"{counts[nm]} times on the fused route")
        self.time_shape(fused, SUBMIT_BATCH, 227, 256, "predict_submission step")

    def forecast_phase(self):
        """Phase 19: `cli/forecast_submission` at ForecastSpec's defaults,
        FORECAST_EPOCHS epochs: phi forward launches only; then the phi
        kernel against its plain version at the forecaster's and the
        legacy basis's shapes."""
        import numpy as np

        from st_dadk_tpu_torch.cli import forecast_submission as fs
        from st_dadk_tpu_torch.models import legacy_basis
        from st_dadk_tpu_torch.models.forecaster import ForecastSpec
        from st_dadk_tpu_torch.ops.basis import (BASIS_IDS,
                                                 CALIBRATION_FACTORS,
                                                 uniform_grid_centers)
        from st_dadk_tpu_torch.train.loop import n_predict_chunks
        torch, sbk = self.torch, self.sbk

        fam = self.competition_family()
        argv = ["--family", str(fam["stem"]),
                "--epochs", str(FORECAST_EPOCHS),
                "--batch_size", str(FORECAST_BATCH),
                "--out", str(fam["stem"].parent / "forecast.csv"),
                "--device", "cuda"]
        summary, counts, n_test = self._submission("forecast_submission",
                                                   fs.main, argv)
        n_ep = summary["hist"]["n_epochs_run"]
        steps = -(-summary["n_train_rows"] // FORECAST_BATCH)
        want = n_ep * (steps + 1) + n_predict_chunks(summary["n_obs_sites"])
        print(f"forecast_submission: {n_test} rows ({summary['n_obs_sites']} "
              f"sites with a complete history), RMSE {summary['rmse']!r} MAE "
              f"{summary['mae']!r}, persistence RMSE "
              f"{summary['persistence_rmse']!r}; {n_ep} epochs x {steps} "
              f"steps in {summary['train_seconds']:.1f} s; launches "
              + json.dumps({k: v for k, v in counts.items() if v}),
              flush=True)
        check(counts["spatial_basis_fwd"] == want,
              f"forecast: phi forward launched {counts['spatial_basis_fwd']} "
              f"times, not {want} (steps, validations, the forecast)")
        for nm, c in counts.items():
            if nm != "spatial_basis_fwd":
                check(c == 0, f"forecast: {nm} launched {c} times")

        # the phi kernel against its plain version at the forecaster's and
        # the legacy basis's shapes
        spec = ForecastSpec()
        bid = BASIS_IDS[spec.spatial_basis_function]
        sc, sb = uniform_grid_centers(spec.k_spatial_centers)
        lc, lb = legacy_basis.legacy_centers_and_bandwidths()
        rtol, atol = BARS["spatial_basis_fwd"]
        gen = torch.Generator().manual_seed(19)
        for what, centers, bws, n in (
                ("forecaster step", sc, sb, FORECAST_BATCH),
                ("forecaster validation", sc, sb, summary["n_valid_rows"]),
                ("legacy basis", lc, lb, LEGACY_PHI_N)):
            coords = torch.rand((n, 2), generator=gen).cuda()
            c = torch.as_tensor(centers).cuda()
            inv_bw = (1.0 / (torch.as_tensor(bws).cuda()
                             * CALIBRATION_FACTORS["wendland"])).contiguous()
            got = (legacy_basis.embed(coords) if what == "legacy basis"
                   else sbk.spatial_basis_fwd(coords, c, inv_bw, bid))
            plain = sbk.plain_fwd(coords, c, inv_bw, bid)
            mx, excess = _err(torch, got, plain, rtol, atol)
            print(f"phi kernel, {what} (N={n}, k={c.shape[0]}): max |d| "
                  f"{mx:.3e} against its plain version (atol {atol})",
                  flush=True)
            check(bool(torch.isfinite(got).all()) and excess <= 0.0,
                  f"phi kernel, {what}: disagrees with its plain version "
                  f"(max |d| {mx:.3e})")
        check(np.isfinite(summary["persistence_rmse"]),
              "forecast: non-finite persistence RMSE")
        self.time_shape(("spatial_basis_fwd",), FORECAST_BATCH,
                        spec.k_spatial, spec.hidden_dims[0], "forecast step")

    def no_hidden_phase(self):
        """Phase 20: a bench fit with no hidden layer (the phi route), then
        the two analysis CLIs on phases 11 and 13's trees."""
        import csv

        import numpy as np

        from st_dadk_tpu_torch.cli import analyze_grid_search as agrid
        from st_dadk_tpu_torch.cli import analyze_table_4_4 as a44

        out_dir = REPO / "build" / "chip_smoke_no_hidden"
        cfg, res, counts, _ = self.fit(
            "no hidden layer", out_dir, hidden_dims=[],
            sparsity_penalty_type="none")
        self.competition_launches["no_hidden_fit"] = counts
        want = self.expected_fwd(res)
        check(counts["spatial_basis_fwd"] == want,
              f"no hidden layer: phi forward launched "
              f"{counts['spatial_basis_fwd']} times, not {want}")
        check(counts["spatial_basis_bwd_centers"] > 0,
              "no hidden layer: basis d centers never launched")
        for nm, c in counts.items():
            if nm.startswith("fused_first_layer") or nm.endswith("bwd_points"):
                check(c == 0, f"no hidden layer: {nm} launched {c} times")
        check(res["model_parameters"] == (
            (sum(cfg["k_spatial_centers"]) + sum(cfg["k_temporal_centers"])
             + 1) * len(cfg["quantile_levels"])
            + 3 * sum(cfg["k_spatial_centers"])),
            f"no hidden layer: {res['model_parameters']} parameters")

        t44 = REPO / "build" / "chip_smoke_table_4_4"
        with open(a44.main([str(t44)]), newline="", encoding="utf-8") as f:
            rows = list(csv.reader(f))
        check(len(rows) == 5 and all(len(r) == 3 and all(r[1:])
                                     for r in rows[1:]),
              f"table_4_4_rendered.csv: {rows}")
        grid = REPO / "build" / "chip_smoke_grid"
        detailed = agrid.main([str(grid)])
        check(len(detailed) > 0 and all(
            np.isfinite(d["test_crps_mean"]) for d in detailed)
            and (grid / "detailed_summary.csv").exists(),
            f"detailed_summary: {detailed}")
        print(f"analysis: Table 4.4 rendered ({len(rows) - 1} scenarios x "
              f"{len(rows[0]) - 1} models), grid detailed summary "
              f"{len(detailed)} rows", flush=True)

    def saved_model(self, cfg, out_dir, device, pad=None):
        """The fit's saved params as a model on `device`; with `pad`, padded
        back to that width (a ragged lane, with its mask)."""
        import numpy as np

        from st_dadk_tpu_torch.config import ExperimentConfig
        from st_dadk_tpu_torch.models.st_interp import (from_jax_params,
                                                        pad_lane_model,
                                                        spec_from_config)
        from st_dadk_tpu_torch.train.experiment import (load_params_npz,
                                                        real_lane_spec)

        ecfg = ExperimentConfig.from_dict(cfg)
        spec = spec_from_config(ecfg)
        params = load_params_npz(out_dir / "model_final.npz")
        bi = np.load(out_dir / "basis_info.npz")
        consts = {"spatial_centers_init": bi["spatial_centers_init"],
                  "spatial_bandwidths_init": bi["spatial_bandwidths_init"]}
        if ecfg.k_spatial_pad is not None:
            real = real_lane_spec(ecfg, spec)
            if pad is None:
                spec = real
            else:
                params, consts = pad_lane_model(real, pad, params, consts)
        model = from_jax_params(spec, params, consts, device=device)
        for p in model.parameters():
            p.requires_grad_(False)
        return model, spec

    @staticmethod
    def grad_points(dense):
        import numpy as np

        T, S = dense["predictions"].shape
        rng = np.random.default_rng(0)
        tt = rng.integers(0, T, GRAD_POINTS)
        ss = rng.integers(0, S, GRAD_POINTS)
        t_norm = (tt / (T - 1)).astype(np.float32)[:, None]
        return dense["coords"][ss].astype(np.float32), t_norm, tt, ss

    def spatial_gradients(self, bench, lane, launches):
        """Phase 5: d (median quantile) / d coords on 2,000 dense points
        through each fitted model on the card, against the plain CPU
        forward's autograd from the same saved params."""
        import numpy as np
        torch = self.torch

        def dcoords(model, coords, t_norm, mid):
            dev = next(model.parameters()).device
            s = torch.as_tensor(coords, device=dev).requires_grad_(True)
            out = model(s, torch.as_tensor(t_norm, device=dev))[:, mid]
            (g,) = torch.autograd.grad(out.sum(), (s,))
            return g.cpu().numpy()

        for (cfg, _, out_dir), kern in (
                (bench, "fused_first_layer_bwd_points"),
                (lane, "spatial_basis_bwd_points")):
            dense = np.load(out_dir / "predictions.npz")
            coords, t_norm, _, _ = self.grad_points(dense)
            mid = len(cfg["quantile_levels"]) // 2
            ragged = cfg.get("k_spatial_pad") is not None
            card, _ = self.saved_model(cfg, out_dir, "cuda",
                                       pad=LANE_PAD if ragged else None)
            got, counts = self.counted(
                lambda: dcoords(card, coords, t_norm, mid))
            plain, _ = self.saved_model(cfg, out_dir, "cpu")
            want = dcoords(plain, coords, t_norm, mid)
            mx, excess = _err(torch, torch.as_tensor(got),
                              torch.as_tensor(want), MODEL_GRAD_RTOL,
                              MODEL_GRAD_ATOL)
            route = "ragged lane, phi" if ragged else "bench fit, fused"
            print(f"d yhat/d coords ({route} route): max |d| {mx:.3e} vs "
                  f"plain CPU autograd (max |g| "
                  f"{float(np.abs(want).max()):.3e}); launches "
                  f"{json.dumps({k: v for k, v in counts.items() if v})}",
                  flush=True)
            check(bool(np.all(np.isfinite(got))), "non-finite d coords")
            check(excess <= 0.0, f"d coords disagree with the plain CPU "
                  f"autograd (max |d| {mx:.3e}, rtol {MODEL_GRAD_RTOL}, atol "
                  f"{MODEL_GRAD_ATOL})")
            check(counts[kern] == 1, f"{kern} launched {counts[kern]} times, "
                  f"not once, for one spatial gradient")
            launches[kern] = counts[kern]


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
