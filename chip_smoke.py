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
     its real columns and exactly 0 on its masked ones; then at the launch
     shapes the later paths added (ADDED_TIMED, ADDED_LANE_TIMED: the dense
     tool's N = 131,072, a dp or nested rank's step at N = 256, the
     bench's 16-lane validation), each held and timed as at the fit shapes;
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
 22. the bf16 trunk (`train_dtype: bf16`): the bench fit on the fused route,
     12 epochs, held to phase 3's float32 fit by |d RMSE| < 0.15
     (tests/test_train_loop.py:394), then the ragged lane of phase 4 in
     bf16 on the phi route, held to phase 4 alike; ms a step of each
     beside float32's, and the kernels' launches;
 23. the packed optimizer (`packed_optimizer: true`): the bench fit and
     phase 6's 4-lane batch packed against phases 3 and 6, unpacked: loss
     histories within LANE_EARLY_RTOL in epochs 1-3 and within phase 6's
     drift rule after (the drift of the bench fit with W_s one ulp up),
     scores likewise; device activities a step both ways (torch.profiler,
     a 2-epoch fit and a 2-epoch 4-lane batch each);
 24. tail compaction: COMPACT_LANES lanes at patience 1 with a plateau
     margin, compacted at a multiple of COMPACT_EVERY epochs against the
     same batch uncompacted:
     the batch must narrow (the compaction line is printed), every lane's
     stop epoch must be equal both ways and its histories and scores hold
     by the drift rule of phase 23.
 25. several ranks, data-parallel: the bench fit through
     `run_multiple_experiments(engine="dp")` in a one-rank nccl group, its
     history, scores and launches bitwise phase 3's; then in RANKS gloo
     ranks on the one card (nccl refuses two ranks on one device; gloo
     takes the CUDA tensors), held to phase 3 by the drift rule against
     the bench fit with its minibatch rows reversed (the same change of
     summation order on one rank), its params bitwise equal across ranks;
 26. `fit_tp` in RANKS gloo ranks, the 227 centers split 114 a rank (one
     pad row): histories by the drift rule of phase 23, the pad rows exactly
     0 and the pad centers exactly their initial values, the fused kernels'
     launches at k = 114;
 27. `cli/train_st_interp.py --engine vmap` in RANKS processes, RANK_LANES
     seeds at dropout 0 under shuffle 'none': each process writes its lanes
     only and the primary alone the summary; each lane against the same
     seed's lane of one process's batch, bitwise or by the drift rule
     (printed which);
 28. phase 17's resume through a checkpoint directory
     (torch.distributed.checkpoint), bitwise the straight fit;
 29. lanes nested over an exp x data mesh (NESTED_MESH) of gloo ranks on the
     card through `run_job_batch(mesh=...)`, twice: phase 27's lanes
     (dropout 0, shuffle 'none'), held to phase 27's one-process batch, and
     the bench workload's lanes (its dropout and shuffle), held to one
     process's batch of each data row's lanes; each by the drift rule
     against its own config's fit with its minibatch rows reversed; the
     lanes each rank owns and writes, its launches;
 30. phase 6's lanes with artifacts and figures off, scored by the device
     metrics: the params stay on the card, fits bitwise phase 6's, every
     metric within DEVICE_METRICS_RTOL of the host path's;
 31. `trace_steady_state`'s capture and analysis of a short pipelined
     stream: device time in every stage family, under TRACE_OTHER_SHARE of
     it unclaimed by any stage, every host-device copy of the trace in a
     copy family, the clock probe's launch inside its program span within
     TRACE_CLOCK_SLACK_US, the idle time by the main thread's spans summing
     to the span's idle time;
 32. the fits/hour bench (`python3 -m st_dadk_tpu_torch.bench`) in a child
     process, cut to BENCH_M jobs a batch in BENCH_LANE_WIDTH-lane batches,
     BENCH_WINDOWS windows of at least BENCH_WINDOW_SECONDS s and
     BENCH_EPOCHS epochs: its last line (the card's name, platform gpu), its
     details file, fits equal to the jobs run, and non-zero launches of the
     three kernels a fit trains through over its windows;
 33. the dense-inference bench (`bench_dense_inference.run`) at DENSE_N
     points, DENSE_REPS calls a trial: its three arms' agreement and launch
     checks (each raises), every arm's time finite;
 34. the synthesize CLIs (`cli/synthesize_1b3b.py`, `cli/synthesize_2b.py`)
     through their `main` on the card at the JAX scripts' scale, on input
     trees generated from seeds under a temporary directory: 1b_2 (100,000
     test sites, 900,000 train rows at m = 4,096), 3b_1 (50,000 sites, two
     columns mixed at rho 0.5) and 2b_8 (the covariance fitted to the bench
     field, 5,000 sites x T = 100, cut from 2b's 10,000): the files,
     columns and rows, every value finite; eval_latent at n = 1,000,000
     timed on the CLI's own features, its std, the CLI's values bitwise
     sample_field of it, and 4,096 of its points within SYNTH_F64_BAR of a
     float64 numpy evaluation; the refitted range, sill and nugget beside
     the generating ones. It launches none of the seven kernels.
The device metrics' per-lane fallback (`batch_engine.eval_fallbacks`) must
not fire in any phase: the run fails after the first phase in which it did.
Phases 25 (ii)-27 run in one launch of RANKS child processes (spawned; each
loads the libraries built here), whose launch counts and shapes come back.
Phases 22-34 run before phase 21, whose shapes include theirs (phase 32's
child counts its own launches and keeps its shapes).
Each of phases 3-7, 11-13, 15, 18-20, 22-27 (in each child rank), 32 (in
the bench's child, around its windows) and 33 sets the launch counts to 0
just before it and reads them just after; it checks the fit's losses,
centers and test metrics. The last line of standard output is one JSON
object with "ok" and the device; the line before it lists the kernels, with
the launches of phases 18-20 under "competition_launches", those of phases
22-24 under "option_launches", those of phases 25-27 by rank under
"parallel_launches", those of phases 32-33 under "tool_launches" and, as
"max_abs_err", the worst difference
from the plain version in phases 2, 18-19 and 21.
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
# launch shapes the paths added after the three fit shapes, timed as those
# are: the dense tool's N (fused and phi forward), a dp or nested rank's
# step at N = 256 (the fused trio) and the bench's 16-lane validation
ADDED_TIMED = [((131072, 227, 256), ("fused_first_layer_fwd",
                                     "spatial_basis_fwd")),
               ((256, 227, 256), ("fused_first_layer_fwd",
                                  "fused_first_layer_bwd_w",
                                  "fused_first_layer_bwd_centers"))]
ADDED_LANE_TIMED = [(16, 2000, 227, 256)]
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
# phase 22: a bf16 fit against its float32 fit (tests/test_train_loop.py:394)
BF16_RMSE_BAR = 0.15
# phase 23: the short fits profiled for device activities a step
PACKED_PROFILE_EPOCHS = 2
# phase 24: lanes at patience 1 that stop once an epoch's validation loss
# gains less than COMPACT_MIN_GAIN of the best (the EMA's validation loss
# falls for many epochs, by 0.7-2.5 % an epoch in epochs 5-12 of the bench
# fit on the stand-in field); compaction is tried every COMPACT_EVERY
# epochs, within a cap of COMPACT_EPOCHS
COMPACT_LANES, COMPACT_EVERY, COMPACT_EPOCHS = 8, 2, 40
COMPACT_MIN_GAIN = 0.01
# JAX's keys of nan_diagnostics.json (st_dadk_tpu/train/experiment.py:415)
# phases 25-27: ranks of one group on the one card (gloo; nccl refuses two
# ranks on one device), the lanes of the lane CLI, the seconds a group's
# init or collective and the whole launch may take, and the bench
# workload's 227 centers split over the ranks (228, 114 a rank)
RANKS, RANK_LANES = 2, 4
RANK_TIMEOUT, RANK_JOIN_TIMEOUT = 60.0, 300.0
TP_K_LOCAL = 114
# phase 29: phase 27's lanes over an exp x data mesh of gloo ranks on the
# card, each data row's lanes a data-parallel fit over the row
NESTED_MESH = (("exp", 2), ("data", 2))
# phase 30: the device metrics against the host path's scores of the same
# fit (tests/test_torch_device_metrics.py's bar)
DEVICE_METRICS_RTOL = 1e-5
# phase 31: the trace tool's capture; the share of its device time that no
# stage claims (none in a healthy capture: every launch of the stream comes
# from a stage); how far a launch's runtime call may lie outside the
# program span around it on the trace's clock (the clock the stages are
# placed by; tests/test_torch_trace_clock.py's bar)
TRACE_BATCHES, TRACE_LANES, TRACE_EPOCHS = 3, 4, 2
TRACE_OTHER_SHARE = 0.01
TRACE_CLOCK_SLACK_US = 50.0
# phase 32: the bench tool in a child process, cut to seconds; phase 33:
# the dense-inference tool
BENCH_M, BENCH_LANE_WIDTH, BENCH_WINDOWS = 4, 2, 2
BENCH_WINDOW_SECONDS, BENCH_EPOCHS = 1.0, 2
BENCH_TIMEOUT = 300
DENSE_N, DENSE_REPS = 32768, 5
# phase 34: the synthesize CLIs at the JAX scripts' scale on generated input
# trees: 1b_2's 100,000 test sites (its solutions drawn from the 1b_2 entry
# of data/1b/fit_params.json, the one with a nugget), 3b_1's 50,000 sites
# (two columns mixed at SYNTH_3B_RHO), 2b_8's sites x T = 100 from the
# covariance fitted to the bench field, cut from 2b's 10,000 sites to
# 5,000 to keep the phase near a minute (the host's Matern covariance,
# scipy's K_1 over S^2 pairs on one core, grows with S^2 and the Cholesky
# with S^3); the scripts' m = 4,096 features
# and seed; eval_latent against float64 numpy on SYNTH_F64_POINTS points at
# the script's accepted phase error (scripts/synthesize_1b3b.py:103-106);
# the latent's std and the refit round trip as the JAX tests bound them
# (tests/test_family_scoring.py:40-66)
SYNTH_1B_SITES, SYNTH_3B_SITES, SYNTH_3B_RHO = 100_000, 50_000, 0.5
SYNTH_2B_SITES, SYNTH_2B_T, SYNTH_2B_TEST_T = 5_000, 100, 10
SYNTH_M, SYNTH_SEED, SYNTH_TRAIN_RATIO = 4096, 2026, 9
SYNTH_F64_POINTS, SYNTH_F64_BAR = 4096, 1e-4
SYNTH_LATENT_STD = (0.85, 1.15)
SYNTH_LATENT_REPS = 3
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


def added_shapes_phase(torch, ffl, sbk, basis_ids, worst):
    """ADDED_TIMED and ADDED_LANE_TIMED: each kernel against its plain
    version at phase 2's bars, then the device time a launch of both
    (CUDA-graph replays in turns plain, kernel, kernel, plain) beside its
    bound (M times one lane's). Returns {kernel: {shape: times}}."""
    from st_dadk_tpu_torch.utils.timing import graph_ms, in_turns

    cases = [((1,) + shape, names) for shape, names in ADDED_TIMED]
    cases += [(shape, LANE_KERNELS) for shape in ADDED_LANE_TIMED]
    print("kernel times at the launch shapes added since the fit shapes, "
          "Wendland, device time a launch (CUDA-graph replay):", flush=True)
    times = {}
    for (lanes, n, k, h), names in cases:
        if lanes == 1:
            coords, centers, bw, w, grad_h, grad_phi = _inputs(
                torch, n, k, h, seed=97)
            pairs = _pairs(ffl, sbk, coords, centers, (1.0 / bw).contiguous(),
                           w, grad_h, grad_phi, basis_ids["wendland"])
        else:
            coords, centers, bw, w, grad_h = _lane_inputs(torch, lanes, n, k,
                                                          h, seed=97)
            pairs = _lane_calls(ffl, coords, centers, (1.0 / bw).contiguous(),
                                w, grad_h, basis_ids["wendland"])
        key = f"M={lanes} N={n} k={k} H={h}"
        for nm in names:
            kern, plain = pairs[nm]
            rtol, atol = BARS[nm]
            for a, b in zip(_outputs(kern()), _outputs(plain())):
                mx, excess = _err(torch, a, b, rtol, atol)
                worst[nm] = max(worst[nm], mx)
                check(bool(torch.isfinite(a).all()) and excess <= 0.0,
                      f"{nm} disagrees with its plain version at {key} "
                      f"(max |d| {mx:.3e})")
            ms, plain_ms = in_turns(graph_ms, plain, kern)
            b, by = bound_ms(nm, n, k, h)
            times.setdefault(nm, {})[key] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": lanes * b,
                "bound_by": by}
            print(f"  {nm:31s} {key}: device {ms:.4f} ms (plain "
                  f"{plain_ms:.4f}), bound {lanes * b:.4f} ms ({by}, "
                  f"{100 * lanes * b / ms:.1f} % of device)", flush=True)
        del coords, centers, bw, w, grad_h, pairs
        torch.cuda.empty_cache()
    return times


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
    added_ms = added_shapes_phase(torch, ffl, sbk, BASIS_IDS, worst)
    launches = {nm: None for nm in KERNELS}
    lane_launches, competition, competition_ms, options = {}, {}, {}, {}
    parallel, tools = {}, {}
    if not args.kernels_only:
        phases = Phases(torch, ffl, sbk)
        launches = phases.run()
        lane_launches = phases.lane_launches
        competition = phases.competition_launches
        competition_ms = phases.competition_times
        options = phases.option_launches
        parallel = phases.parallel_launches
        tools = phases.tool_launches
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
         # device ms a launch at ADDED_TIMED / ADDED_LANE_TIMED
         "added_shapes_ms": added_ms.get(nm),
         # launches in each run of phases 18-20 (the competition path)
         "competition_launches": {run: counts[nm] for run, counts
                                  in competition.items()} or None,
         # device ms a launch at the step shapes of phases 18-19
         "competition_ms": competition_ms.get(nm),
         # launches in each run of phases 22-24 (the fit's options)
         "option_launches": {run: counts[nm] for run, counts
                             in options.items()} or None,
         # launches in each rank's runs of phases 25-27 (dp, fit_tp, lanes
         # across processes; the shapes are in phase 26's lines)
         "parallel_launches": {run: counts[nm] for run, counts
                               in parallel.items()} or None,
         # launches in the bench tools' runs of phases 32-33
         "tool_launches": {run: counts[nm] for run, counts
                           in tools.items()} or None}
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
        self.option_launches = {}
        self.parallel_launches = {}
        self.tool_launches = {}
        self.lanes_results = None
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
        self.no_fallback("6 (lanes)")
        jobs = self.ragged_lanes_phase({(tuple(RAGGED_GRID[0]), 1): unpadded,
                                        (tuple(RAGGED_GRID[1]), 1): bench[1]})
        self.no_fallback("7 (ragged lanes)")
        self.pipeline_phase()
        self.no_fallback("8 (pipeline)")
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
                            ("22 (bf16 trunk)",
                             lambda: self.bf16_phase(bench, lane)),
                            ("23 (packed optimizer)",
                             lambda: self.packed_phase(bench)),
                            ("24 (tail compaction)", self.compaction_phase),
                            ("25 (dp)", lambda: self.dp_phase(bench)),
                            ("26 (tensor parallel)",
                             lambda: self.tp_phase(bench)),
                            ("27 (lanes across processes)",
                             lambda: self.ranks_lanes_phase(bench)),
                            ("28 (checkpoint directory)",
                             self.checkpoint_dir_phase),
                            ("29 (nested exp x data lanes)",
                             self.nested_lanes_phase),
                            ("30 (device metrics)",
                             self.device_metrics_phase),
                            ("31 (steady-state trace)", self.trace_phase),
                            ("32 (fits/hour bench)", self.bench_tool_phase),
                            ("33 (dense-inference bench)",
                             self.dense_tool_phase),
                            ("34 (synthesize CLIs)", self.synthesize_phase),
                            ("21 (every launch shape)",
                             self.launch_shapes_phase)):
            t0 = time.time()
            phase()
            self.no_fallback(name)
            print(f"phase {name}: {time.time() - t0:.1f} s", flush=True)
        return launches

    @staticmethod
    def no_fallback(name):
        """Fails the run if a batch's device metrics fell back to the
        per-lane evaluation so far (the count is the process's)."""
        from st_dadk_tpu_torch.train import batch_engine as tbe

        check(tbe.eval_fallbacks == 0,
              f"phase {name}: the device metrics fell back to the per-lane "
              f"evaluation {tbe.eval_fallbacks} times")

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
        self.bench_counts = counts
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
        self.lane_counts = counts
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
        self.lanes_results = results
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
        self.resume_straight = straight

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

    # -- phases 25-28: several ranks (parallel/), the checkpoint directory --

    def two_ranks(self):
        """Phases 25 (ii)-27's work in one launch of RANKS gloo ranks on the
        card (`_rank_runs`), run once; each rank's runs come back with
        their launch counts and shapes, which join phase 21's list."""
        if getattr(self, "_ranks", None) is None:
            from st_dadk_tpu_torch.bench_workload import bench_workload
            from st_dadk_tpu_torch.config import write_yaml
            from st_dadk_tpu_torch.parallel.launch import run_ranks
            import shutil
            root = REPO / "build" / "chip_smoke_ranks"
            shutil.rmtree(root, ignore_errors=True)
            root.mkdir(parents=True)
            write_yaml(dict(bench_workload(
                data_file=str(self.data_file), epochs=EPOCHS,
                n_experiments=RANK_LANES, dropout=0.0, shuffle="none",
                device="cuda", save_plots=False, save_artifacts=True),
                tag="ranks"),
                root / "lanes.yaml")
            t0 = time.time()
            self._ranks = run_ranks(_rank_runs, RANKS,
                                    (str(self.data_file), str(root)),
                                    backend="gloo", device="cuda",
                                    timeout=RANK_TIMEOUT,
                                    join_timeout=RANK_JOIN_TIMEOUT)
            print(f"{RANKS} gloo ranks on the card (one child process a "
                  f"rank): {time.time() - t0:.1f} s, child start included",
                  flush=True)
            for r, runs in enumerate(self._ranks):
                for run, got in runs.items():
                    if "counts" in got:
                        self.parallel_launches[f"{run} rank {r}"] = \
                            got["counts"]
                        for nm, keys in got["shapes"].items():
                            self.launched.setdefault(nm, set()).update(
                                tuple(k) for k in keys)
        return self._ranks

    def dp_phase(self, bench):
        """Phase 25: (i) the bench fit through run_multiple_experiments(
        engine='dp') in a one-rank nccl group, bitwise phase 3; (ii) the same
        over RANKS gloo ranks on the card, held to phase 3 by the drift
        rule, its params bitwise equal across the ranks. The split sums
        every step's gradients over the points in another order, which a
        one-ulp start (phase 6's reference) underestimates where the fit
        turns chaotic (epoch 5 of the bench schedule); the reference here is
        the bench fit with its minibatch rows reversed (`reordered_drift`),
        the same change of summation order on one rank."""
        import numpy as np

        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.parallel import multihost as mh
        from st_dadk_tpu_torch.parallel.launch import free_port
        from st_dadk_tpu_torch.train.runner import run_multiple_experiments
        import shutil

        out = REPO / "build" / "chip_smoke_dp1"
        shutil.rmtree(out, ignore_errors=True)
        cfg = bench_workload(data_file=str(self.data_file), epochs=EPOCHS,
                             save_artifacts=True, n_experiments=1)
        mh.maybe_initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                        backend="nccl", device="cuda:0",
                                        timeout=RANK_TIMEOUT)
        try:
            check(self.torch.distributed.get_backend() == "nccl",
                  "phase 25: the one-rank group is not nccl")
            _, counts = self.counted(lambda: run_multiple_experiments(
                cfg, out, engine="dp"))
        finally:
            mh.shutdown()
        got = json.loads((out / "experiments" / "1" / "results.json")
                         .read_text())
        want = json.loads((bench[2] / "results.json").read_text())
        same = got["training_history"] == want["training_history"] and all(
            got[k] == want[k] for k in LANE_SCORES)
        print(f"dp, one nccl rank: test RMSE {got['test_rmse']!r} / phase 3 "
              f"{want['test_rmse']!r}; history and scores bitwise {same}; "
              f"launches {json.dumps({k: v for k, v in counts.items() if v})}",
              flush=True)
        check(same, "phase 25: the one-rank dp fit differs from phase 3")
        check(counts == self.bench_counts, f"phase 25: launches {counts} != "
              f"phase 3's {self.bench_counts}")
        self.parallel_launches["dp 1 rank"] = counts

        ranks = self.two_ranks()
        res = json.loads((REPO / "build" / "chip_smoke_ranks" / "dp" /
                          "experiments" / "1" / "results.json").read_text())
        worst = self.hold_by_drift("dp over 2 ranks", res, want,
                                   self.reordered_drift())
        p0, p1 = (r["dp"]["params"] for r in ranks)
        equal = p0.keys() == p1.keys() and all(
            np.array_equal(p0[k], p1[k]) for k in p0)
        ms = {nm: 1e3 * r["stage_timings"]["train_steps_seconds"]
              / r["n_steps"] for nm, r in (("dp", res), ("phase 3", want))}
        print(f"dp, {RANKS} gloo ranks: test RMSE {res['test_rmse']!r}; loss "
              f"histories within {worst:.1e} of phase 3 (drift rule); params "
              f"bitwise equal across ranks {equal}; ms a step "
              f"{ms['dp']:.3f} (phase 3 {ms['phase 3']:.3f}); launches a rank "
              + json.dumps([{k: v for k, v in r["dp"]["counts"].items() if v}
                            for r in ranks])
              + " at N = " + str(sorted({k[1] for r in ranks for k in
                                         r["dp"]["shapes"][
                                             "fused_first_layer_bwd_w"]})),
              flush=True)
        check(equal, "phase 25: the ranks' params differ")
        for r in ranks:
            check(r["dp"]["counts"]["fused_first_layer_bwd_w"]
                  == res["n_steps"], "phase 25: dW launches != steps")

    def tp_phase(self, bench):
        """Phase 26: fit_tp over RANKS gloo ranks on the bench workload, the
        basis axis split (227 -> 228 centers, 114 a rank): histories held to
        phase 3's fit by the drift rule, the pad rows exactly 0 and the pad
        centers exactly their initial values at the end."""
        ranks = self.two_ranks()
        want = json.loads((bench[2] / "results.json").read_text())
        for r, runs in enumerate(ranks):
            tp = runs["tp"]
            self.hold_by_drift(f"fit_tp rank {r}", tp, want,
                               self.nudged_drift(bench), scores=False)
            ks = sorted({k[2] for k in tp["shapes"]["fused_first_layer_fwd"]})
            print(f"fit_tp rank {r}: {tp['n_epochs_run']} epochs, final train "
                  f"loss {tp['training_history']['train_loss'][-1]!r} (phase "
                  f"3 {want['training_history']['train_loss'][-1]!r}); fused "
                  f"launches {json.dumps({k: v for k, v in tp['counts'].items() if v})}"
                  f" at k = {ks}; pad rows {tp['pad_rows']}: inert "
                  f"{tp['pads_inert']}", flush=True)
            check(ks == [TP_K_LOCAL], f"phase 26: the shard launched at k = "
                  f"{ks}, not {TP_K_LOCAL}")
            check(tp["pads_inert"], f"phase 26: rank {r}'s pad rows moved")
        check(sum(r["tp"]["pad_rows"] for r in ranks) == 1,
              "phase 26: 227 centers over 2 ranks leave one pad row")

    def ranks_lanes_phase(self, bench):
        """Phase 27: cli/train_st_interp --engine vmap in RANKS processes on
        the card, RANK_LANES seeds at dropout 0 under shuffle 'none': each
        process writes its lanes only, the primary alone the summary, and
        each lane against the same seed's lane of a single-process batch,
        bitwise or else by the drift rule."""
        import shutil

        from st_dadk_tpu_torch.config import ExperimentConfig
        from st_dadk_tpu_torch.train.runner import run_multiple_experiments

        ranks = self.two_ranks()
        root = REPO / "build" / "chip_smoke_ranks"
        per = RANK_LANES // RANKS
        for r, runs in enumerate(ranks):
            want = list(range(r * per + 1, (r + 1) * per + 1))
            print(f"lanes rank {r}: wrote experiments "
                  f"{runs['lanes']['written']}, summary "
                  f"{runs['lanes']['summary']}; launches "
                  f"{json.dumps({k: v for k, v in runs['lanes']['counts'].items() if v})}",
                  flush=True)
            check(runs["lanes"]["written"] == want,
                  f"phase 27: rank {r} wrote {runs['lanes']['written']}, not "
                  f"{want}")
            check(runs["lanes"]["summary"] == (r == 0),
                  f"phase 27: rank {r} summary {runs['lanes']['summary']}")
        check((root / "lanes" / "summary" / "summary_statistics.json")
              .exists(), "phase 27: no summary")
        single = root / "single"
        shutil.rmtree(single, ignore_errors=True)
        cfg = ExperimentConfig.from_yaml(root / "lanes.yaml")
        run_multiple_experiments(cfg, single, engine="vmap", device="cuda")
        import numpy as np

        bitwise = same_params = True
        for i in range(1, RANK_LANES + 1):
            a_dir = root / "lanes" / "experiments" / str(i)
            b_dir = single / "experiments" / str(i)
            a = json.loads((a_dir / "results.json").read_text())
            b = json.loads((b_dir / "results.json").read_text())
            same = a["training_history"] == b["training_history"] and all(
                a[k] == b[k] for k in LANE_SCORES)
            bitwise = bitwise and same
            pa, pb = (np.load(d / "model_final.npz") for d in (a_dir, b_dir))
            same_params = same_params and pa.files == pb.files and all(
                np.array_equal(pa[k], pb[k]) for k in pa.files)
            if not same:
                self.hold_by_drift(f"lane {i} across processes", a, b,
                                   self.nudged_drift(bench))
        print(f"lanes across {RANKS} processes against one process's batch "
              f"of {RANK_LANES}: histories and scores "
              + ("bitwise" if bitwise else "by the drift rule (not bitwise)")
              + f"; final params bitwise {same_params}", flush=True)

    def checkpoint_dir_phase(self):
        """Phase 28: phase 17's resume through a checkpoint directory
        (torch.distributed.checkpoint): RESUME_AT epochs into it, then a
        resume, bitwise phase 17's straight fit."""
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

        ckpt = REPO / "build" / "chip_smoke_resume_dir"
        shutil.rmtree(ckpt, ignore_errors=True)
        part = run(checkpoint_path=ckpt, session_epochs=RESUME_AT)
        check((ckpt / "state" / ".metadata").is_file(),
              "phase 28: no checkpoint directory written")
        resumed = run(checkpoint_path=ckpt, resume=True)
        straight = self.resume_straight
        same = part.n_epochs_run == RESUME_AT and all(
            np.array_equal(straight.history[k], resumed.history[k])
            for k in ("train_loss", "val_loss", "val_rmse"))
        flat = texp._flatten_params
        for tree in ("params", "final_ema"):
            a, b = flat(getattr(straight, tree)), flat(getattr(resumed, tree))
            same = same and all(np.array_equal(a[k], b[k]) for k in a)
        print(f"checkpoint directory: {RESUME_AT} epochs + resume against "
              f"{RESUME_EPOCHS} straight: bitwise {same}", flush=True)
        check(same, "phase 28: the fit resumed from a directory differs")

    def nested_lanes_phase(self):
        """Phase 29: lanes through `run_job_batch` over an exp x data mesh of
        gloo ranks on the card (NESTED_MESH): each data row owns the lanes
        of its exp coordinate, every lane a data-parallel fit over the row,
        and the row's rank 0 alone writes them. Two runs in the same ranks:
        phase 27's lanes (RANK_LANES seeds at dropout 0, shuffle 'none'),
        held to phase 27's single-process batch, and the bench workload's
        RANK_LANES lanes with its dropout and shuffle (each rank takes its
        rows of the minibatch's dropout block and order), held to one
        process's batch of each data row's lanes (a lane's masks come from
        its batch's generator). Each is held by the drift rule against its
        own config's fit with every minibatch's rows reversed (the split
        changes the order of every step's sums over the points, and how far
        that moves a fit depends on the config): phase 27's config's, and
        phase 25's for the bench workload."""
        import shutil

        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.config import ExperimentConfig, write_yaml
        from st_dadk_tpu_torch.parallel.launch import run_ranks
        from st_dadk_tpu_torch.train import batch_engine

        root = REPO / "build" / "chip_smoke_ranks"
        out = REPO / "build" / "chip_smoke_nested"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        bench_cfg = dict(bench_workload(
            data_file=str(self.data_file), epochs=EPOCHS,
            n_experiments=RANK_LANES, device="cuda", save_plots=False,
            save_artifacts=True), tag="nested")
        write_yaml(bench_cfg, out / "bench.yaml")
        runs = {"phase 27's lanes": (str(root / "lanes.yaml"),
                                     str(out / "lanes")),
                "bench lanes": (str(out / "bench.yaml"),
                                str(out / "bench"))}
        mesh = dict(NESTED_MESH)
        world = mesh["exp"] * mesh["data"]
        t0 = time.time()
        ranks = run_ranks(_nested_runs, world, (list(runs.values()),),
                          backend="gloo", device="cuda",
                          timeout=RANK_TIMEOUT,
                          join_timeout=RANK_JOIN_TIMEOUT)
        print(f"{world} gloo ranks on the card as exp x data = {mesh}, "
              f"{len(runs)} runs: {time.time() - t0:.1f} s, child start "
              f"included", flush=True)
        per = RANK_LANES // mesh["exp"]
        for r, got_runs in enumerate(ranks):
            row, col = divmod(r, mesh["data"])
            lanes = list(range(row * per + 1, (row + 1) * per + 1))
            for run, got in zip(runs, got_runs):
                ns = sorted({key[1] for key in
                             got["shapes"]["fused_first_layer_bwd_w"]})
                print(f"nested {run}, rank {r} (exp {row}, data {col}): "
                      f"lanes {got['lanes']}, wrote {got['written']}; "
                      f"launches "
                      f"{json.dumps({k: v for k, v in got['counts'].items() if v})}"
                      f" (dW at N = {ns})", flush=True)
                check(got["lanes"] == lanes, f"phase 29: {run}, rank {r} "
                      f"owns {got['lanes']}, not {lanes}")
                check(got["written"] == (lanes if col == 0 else []),
                      f"phase 29: {run}, rank {r} wrote {got['written']}")
                for nm in LANE_KERNELS:
                    check(got["counts"][nm] > 0,
                          f"phase 29: {run}, rank {r} never launched {nm}")
                self.parallel_launches[f"nested {run} rank {r}"] = \
                    got["counts"]
                for nm, keys in got["shapes"].items():
                    self.launched.setdefault(nm, set()).update(
                        tuple(key) for key in keys)
        # the bench lanes' reference: one process's batch of each row's lanes
        cfg = ExperimentConfig.from_dict(bench_cfg)
        for row in range(mesh["exp"]):
            batch_engine.run_job_batch(
                [(cfg, i, out / "single" / "experiments" / str(i))
                 for i in range(row * per + 1, (row + 1) * per + 1)],
                device="cuda")
        refs = {"phase 27's lanes": (
                    root / "single",
                    self.reordered_drift_of(
                        "phase 27's lane config",
                        ExperimentConfig.from_yaml(root / "lanes.yaml")
                        .to_dict())),
                "bench lanes": (out / "single", self.reordered_drift())}
        for run, (ref_dir, drift) in refs.items():
            worst = 0.0
            for i in range(1, RANK_LANES + 1):
                a = json.loads((Path(runs[run][1]) / "experiments" / str(i)
                                / "results.json").read_text())
                b = json.loads((ref_dir / "experiments" / str(i) /
                                "results.json").read_text())
                worst = max(worst, self.hold_by_drift(
                    f"nested {run}, lane {i}", a, b, drift))
            print(f"nested {run} against one process's batch: loss "
                  f"histories within {worst:.1e} (drift rule, reordered "
                  f"rows)", flush=True)

    def device_metrics_phase(self):
        """Phase 30: phase 6's LANES lanes again with artifacts and figures
        off, so that the batch is scored by the device metrics
        (`_batched_eval_device`: only (M, 3, K) scalars leave the card):
        the serving params stay on the card, neither the host evaluation
        nor the per-lane fallback runs, the fit is bitwise phase 6's, and
        every lane's scores are phase 6's (the host path's) within
        DEVICE_METRICS_RTOL."""
        import contextlib
        import io
        import shutil

        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.train import batch_engine as tbe
        from st_dadk_tpu_torch.train.runner import run_multiple_experiments

        out_dir = REPO / "build" / "chip_smoke_device_metrics"
        shutil.rmtree(out_dir, ignore_errors=True)
        cfg = bench_workload(data_file=str(self.data_file), epochs=EPOCHS,
                             n_experiments=LANES, save_artifacts=False,
                             save_plots=False)
        seen = {"device": 0, "host": 0, "on_device": None}
        saved = (tbe._batched_eval_device, tbe._batched_eval,
                 tbe._finalize_job_batch)

        def device(*a, **kw):
            seen["device"] += 1
            return saved[0](*a, **kw)

        def host(*a, **kw):
            seen["host"] += 1
            return saved[1](*a, **kw)

        def finalize(state):
            seen["on_device"] = all(r.params is None
                                    for r in state["results"])
            return saved[2](state)

        tbe._batched_eval_device, tbe._batched_eval = device, host
        tbe._finalize_job_batch = finalize
        log = io.StringIO()
        try:
            with contextlib.redirect_stdout(log):
                _, counts = self.counted(lambda: run_multiple_experiments(
                    cfg, out_dir, engine="vmap", device="cuda"))
        finally:
            (tbe._batched_eval_device, tbe._batched_eval,
             tbe._finalize_job_batch) = saved
        print(log.getvalue(), end="", flush=True)
        check("falling back per-lane" not in log.getvalue(),
              "phase 30: the device evaluation failed and fell back")
        check(seen["device"] == 1 and seen["host"] == 0,
              f"phase 30: device evaluations {seen['device']}, host "
              f"evaluations {seen['host']}")
        check(seen["on_device"] is True,
              "phase 30: the serving params left the card before finalize")
        worst, secs = 0.0, []
        for i in range(1, LANES + 1):
            got = json.loads((out_dir / "experiments" / str(i) /
                              "results.json").read_text())
            want = self.lanes_results[i - 1]
            check(got["training_history"] == want["training_history"],
                  f"phase 30: lane {i}'s fit differs from phase 6's")
            for split in ("train", "valid", "test"):
                for m, v in want["metrics"][split].items():
                    gap = abs(got["metrics"][split][m] - v) / abs(v)
                    worst = max(worst, gap)
                    check(gap <= DEVICE_METRICS_RTOL,
                          f"phase 30: lane {i} {split} {m} "
                          f"{got['metrics'][split][m]!r} is {gap:.2e} from "
                          f"the host path's {v!r}")
            secs.append((got["stage_timings"]["batch_eval_seconds"],
                         want["stage_timings"]["batch_eval_seconds"]))
        print(f"device metrics of {LANES} lanes: fits bitwise phase 6's, "
              f"every metric within {worst:.1e} of the host path's (bar "
              f"{DEVICE_METRICS_RTOL}); batch evaluation {secs[0][0]:.3f} s "
              f"(host path {secs[0][1]:.3f} s); launches "
              f"{json.dumps({k: v for k, v in counts.items() if v})}",
              flush=True)

    def trace_phase(self):
        """Phase 31: `trace_steady_state`'s capture of TRACE_BATCHES
        batches of TRACE_LANES lanes, TRACE_EPOCHS epochs each (CUDA
        activities alone: the CPU ops add most of a trace's size and its
        export time; no warm-up batch: the earlier phases ran every path
        it takes), and its analysis: device time in every stage family;
        under TRACE_OTHER_SHARE of the device time, over the span and in
        each steady period, in 'other' (no stage claims it: a launch the
        attribution lost); the copy families' activities, summed, equal to
        every host-device copy of the trace, read from the trace itself;
        the capture's clock probe within TRACE_CLOCK_SLACK_US; and the
        device's idle time by the main thread's innermost span summing to
        the span's idle time."""
        import gzip
        import shutil

        from st_dadk_tpu_torch import trace_steady_state as tts

        out = REPO / "build" / "chip_smoke_trace"
        shutil.rmtree(out, ignore_errors=True)
        meta, _ = self.counted(lambda: tts.capture(
            out, TRACE_BATCHES, TRACE_LANES, TRACE_EPOCHS, ops=False,
            warmup=False))
        trace = json.loads(gzip.decompress((out / "trace.json.gz")
                                           .read_bytes()))
        report = tts.analyze(out, trace)
        tts.print_report(report)
        fam = report["family_seconds"]
        for f in ("init", "fit step", "eval/finalize"):
            check(fam.get(f, 0.0) > 0.0, f"phase 31: no device time in {f}")
        check(fam.get("other", 0.0) <= TRACE_OTHER_SHARE
              * report["device_busy_seconds"],
              f"phase 31: {fam.get('other', 0.0):.4f} s of "
              f"{report['device_busy_seconds']:.4f} s device time claimed "
              f"by no stage")
        # every host-device copy of the trace, and those the analysis put
        # in a copy family: as many, and as long (end - ts rounds each
        # duration at the trace's epoch microseconds: at most half a us)
        raw = [dur for _, dur, cat, name, _ in trace["device"]
               if cat == "gpu_memcpy" and "dtod" not in name.lower()]
        got = [e["end"] - e["ts"] for e in tts.attribute(trace)
               if e["family"] in ("copy H2D", "copy D2H")]
        copies = sum(got)
        check(raw and len(got) == len(raw)
              and abs(copies - sum(raw)) <= 0.5 * len(raw),
              f"phase 31: the copy families hold {len(got)} copies, "
              f"{copies:.1f} us, of the trace's {len(raw)}, "
              f"{sum(raw):.1f} us")
        slack = meta["clock_slack_us"]
        check(slack <= TRACE_CLOCK_SLACK_US,
              f"phase 31: a launch's runtime call lies {slack:.1f} us "
              f"outside the program span around it on the trace's clock")
        idle = report["span_seconds"] - report["device_busy_seconds"]
        by_span = report["idle_by_span"]["main"]
        check(abs(sum(by_span.values()) - idle) <= 1e-6 + 1e-3 * idle,
              f"phase 31: the idle time by the main thread's spans sums to "
              f"{sum(by_span.values()):.6f} s of {idle:.6f} s")
        rows = (report.get("steady") or {}).get("batches", [])
        check(len(rows) == TRACE_BATCHES - 2,
              f"phase 31: {len(rows)} steady rows")
        for r in rows:
            busy = r["wall_seconds"] - r["idle"]
            check(r["other"] <= TRACE_OTHER_SHARE * busy,
                  f"phase 31: batch {r['batch']}: {r['other']:.4f} s of "
                  f"{busy:.4f} s device time claimed by no stage")
        print(f"trace: clock probe {slack:.1f} us outside its span; 'other' "
              f"{fam.get('other', 0.0):.4f} s; copies "
              f"{len(got)}, {copies / 1e6:.6f} s, all of the trace's "
              f"host-device copies ({sum(raw) / 1e6:.6f} s)", flush=True)
        print(f"trace of {meta['fits']} fits: {meta['wall_seconds']:.2f} s in "
              f"the window, export and reduction "
              f"{meta['export_seconds']:.1f} s "
              f"({json.dumps(meta['export_split_seconds'])}); events "
              f"{json.dumps(meta['events'])}", flush=True)

    def bench_tool_phase(self):
        """Phase 32: `python3 -m st_dadk_tpu_torch.bench` in a child process
        (the command a user runs), cut to BENCH_M jobs a batch in
        BENCH_LANE_WIDTH-lane batches, BENCH_WINDOWS windows of
        BENCH_WINDOW_SECONDS s and BENCH_EPOCHS epochs: its last line, its
        details file, fits equal to the jobs run, and the launches of the
        fused forward, dW and d centers over its windows."""
        torch = self.torch
        details = REPO / "build" / "chip_smoke_bench" / "bench_details.json"
        details.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "st_dadk_tpu_torch.bench", str(BENCH_M),
               "--lane_width", str(BENCH_LANE_WIDTH),
               "--windows", str(BENCH_WINDOWS),
               "--window_seconds", str(BENCH_WINDOW_SECONDS),
               "--overrides", json.dumps({"epochs": BENCH_EPOCHS}),
               "--details", str(details)]
        print("bench: " + " ".join(cmd[1:]), flush=True)
        out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=BENCH_TIMEOUT)
        print("\n".join(out.stderr.strip().splitlines()[-6:]), flush=True)
        check(out.returncode == 0, f"phase 32: the bench exited "
              f"{out.returncode}: {out.stderr[-2000:]}")
        last = json.loads(out.stdout.strip().splitlines()[-1])
        dev = last.get("device", {})
        check(last.get("metric") == "fits_per_hour"
              and last.get("unit") == "fits/hour" and last.get("value", 0) > 0,
              f"phase 32: last line {last}")
        check(dev.get("platform") == "gpu"
              and dev.get("kind") == torch.cuda.get_device_name(0),
              f"phase 32: the last line's device {dev}")
        check(details.exists(), "phase 32: no details file")
        d = json.loads(details.read_text())
        check(d["partial"] is False and len(d["windows"]) == BENCH_WINDOWS,
              f"phase 32: details of {len(d['windows'])} windows, partial "
              f"{d['partial']}")
        for w in d["windows"]:
            check(w["fits"] == w["jobs"] > 0
                  and w["wall_seconds"] >= BENCH_WINDOW_SECONDS,
                  f"phase 32: a window of {w['fits']} fits for {w['jobs']} "
                  f"jobs in {w['wall_seconds']:.2f} s")
            check(w["golden"] is not None and all(
                v > 0 for v in w["golden"].values()),
                f"phase 32: probe {w['golden']}")
        for nm in LANE_KERNELS:
            check(d["launches"][nm] > 0,
                  f"phase 32: {nm} never launched in the bench's windows")
        self.tool_launches["bench (phase 32)"] = d["launches"]
        print(f"bench: {last['value']:.1f} fits/hour over "
              f"{sum(w['fits'] for w in d['windows'])} fits, "
              f"{d['data_kind']} data; warm-up "
              f"{json.dumps(d['warmup']['seconds'])} s; probe "
              f"{json.dumps(d['windows'][-1]['golden'])}; launches "
              f"{json.dumps({k: v for k, v in d['launches'].items() if v})}",
              flush=True)

    def dense_tool_phase(self):
        """Phase 33: `bench_dense_inference.run` at DENSE_N points: the
        tool's own checks (the kernel arms against the plain arm, each
        arm's launches) raise on a failure; every arm's numbers finite."""
        import math

        from st_dadk_tpu_torch import bench_dense_inference as bdi

        s, counts = self.counted(lambda: bdi.run(DENSE_N, DENSE_REPS, "cuda"))
        c = s["checks"]
        for arm, a in s["arms"].items():
            check(all(math.isfinite(v) and v > 0 for v in a.values()),
                  f"phase 33: {arm}: {a}")
        self.tool_launches["dense inference (phase 33)"] = counts
        print(f"dense inference at n={DENSE_N}: first layer " + ", ".join(
            f"{arm} {d:.3e}" for arm, d in c["h1_max_abs"].items())
            + f" (bar {c['h1_atol']}), quantiles " + ", ".join(
            f"{arm} {d:.3e}" for arm, d in c["out_max_abs"].items())
            + f" (bar {c['out_atol']}); " + "; ".join(
            f"{arm} {a['amortized_ms']:.4f} ms amortized, "
            f"{a['latency_ms']:.4f} ms latency, {a['mpts_per_s']:.1f} M pts/s,"
            f" peak {a['peak_memory_mib']:.0f} MiB"
            for arm, a in s["arms"].items()), flush=True)

    @staticmethod
    def synth_inputs(ref):
        """Phase 34's reference tree under `ref`: 1b_2 and 3b_1 test sites
        with their solutions, drawn on the card from the generating
        parameters of data/{1b,3b}/fit_params.json, and 2b_8's test sites
        (SYNTH_2B_TEST_T time steps). Returns the generating parameters."""
        import numpy as np

        from st_dadk_tpu_torch.cli import synthesize_1b3b as s13
        from st_dadk_tpu_torch.dataio.kaust import write_columns

        rng = np.random.default_rng(34)
        gen_1b = json.loads((REPO / "data/1b/fit_params.json").read_text())
        gen_3b = json.loads((REPO / "data/3b/fit_params.json").read_text())
        gen = {"1b_2": gen_1b["1b_2"]["z"], "3b_1.z1": gen_3b["3b_1"]["z1"],
               "3b_1.z2": gen_3b["3b_1"]["z2"]}

        def latent(xy, p, seed):
            om, ph = s13.matern_rff(p, SYNTH_M, seed)
            return s13.eval_latent(xy, om, ph, device="cuda")

        for fam, i, n in (("1b", 2, SYNTH_1B_SITES),
                          ("3b", 1, SYNTH_3B_SITES)):
            (ref / fam).mkdir(parents=True)
            xy = rng.uniform(size=(n, 2)).round(6)
            write_columns(ref / fam / f"{fam}_{i}_test.csv",
                          {"x": xy[:, 0], "y": xy[:, 1]})
            if fam == "1b":
                sol = {"z2": s13.sample_field(gen["1b_2"],
                                              latent(xy, gen["1b_2"], 1), 2)}
            else:
                p1, p2 = gen["3b_1.z1"], gen["3b_1.z2"]
                a, b = latent(xy, p1, 3), latent(xy, p2, 4)
                mixed = SYNTH_3B_RHO * a + np.sqrt(1 - SYNTH_3B_RHO ** 2) * b
                sol = {"z1": s13.sample_field(p1, a, 5),
                       "z2": s13.sample_field(p2, mixed, 6)}
            write_columns(ref / fam / f"{fam}-solutions.csv",
                          {"id": np.arange(1, n + 1),
                           **{k: v.astype(np.float32)
                              for k, v in sol.items()}})
        (ref / "2b").mkdir()
        sites = rng.uniform(size=(SYNTH_2B_SITES, 2)).round(6)
        T0 = SYNTH_2B_T - SYNTH_2B_TEST_T + 1
        write_columns(ref / "2b" / "2b_8_test.csv",
                      {"x": np.tile(sites[:, 0], SYNTH_2B_TEST_T),
                       "y": np.tile(sites[:, 1], SYNTH_2B_TEST_T),
                       "t": np.repeat(np.arange(T0, SYNTH_2B_T + 1),
                                      SYNTH_2B_SITES)}, float_format="%.6f")
        return gen

    def synthesize_phase(self):
        """Phase 34: `cli/synthesize_1b3b.py` and `cli/synthesize_2b.py`
        through their `main` on the card at the JAX scripts' scale, on
        input trees generated under a temporary directory (`synth_inputs`;
        2b fits the bench field): the files, columns and rows, every value
        finite; then eval_latent at n = 1,000,000, m = SYNTH_M timed on the
        CLI's own features for 1b_2, its std, the CLI's 1b_2 values
        bitwise sample_field of it, and SYNTH_F64_POINTS of its points
        against a float64 numpy evaluation; the refitted range, sill and
        nugget beside the generating ones (1b_2 and 2b within the JAX
        round trip's bounds)."""
        import tempfile

        import numpy as np

        from st_dadk_tpu_torch.cli import synthesize_1b3b as s13
        from st_dadk_tpu_torch.cli import synthesize_2b as s2b
        from st_dadk_tpu_torch.dataio.kaust import read_columns
        from st_dadk_tpu_torch.dataio.synthetic import standin_path

        torch = self.torch
        n_tr1 = SYNTH_TRAIN_RATIO * SYNTH_1B_SITES
        n_tr3 = SYNTH_TRAIN_RATIO * SYNTH_3B_SITES
        expected = {
            "1b/1b_2.csv": (["id_train", "x", "y", "z"], n_tr1),
            "1b/1b_2_synthsol.csv": (["id", "z"], SYNTH_1B_SITES),
            "3b/3b_1.csv": (["x", "y", "z1", "z2"], n_tr3),
            "3b/3b_1_synthsol.csv": (["id", "z1", "z2"], SYNTH_3B_SITES),
            "2b/2b_8.csv": (["x", "y", "t", "z"],
                            SYNTH_2B_SITES * SYNTH_2B_T)}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_synth") as tmp:
            ref, out = Path(tmp) / "ref", Path(tmp) / "out"
            t0 = time.time()
            gen = self.synth_inputs(ref)
            print(f"synthesize: generated the input trees in "
                  f"{time.time() - t0:.1f} s", flush=True)
            walls = {}
            for name, main, argv in (
                    ("synthesize_1b3b", s13.main,
                     ["--families", "1b", "3b", "--ref_data", str(ref),
                      "--out_root", str(out), "--m_features", str(SYNTH_M),
                      "--seed", str(SYNTH_SEED), "--device", "cuda"]),
                    ("synthesize_2b", s2b.main,
                     ["--indices", "8", "--T", str(SYNTH_2B_T), "--out_dir",
                      str(out / "2b"), "--fit_from", str(self.data_file),
                      "--sites_from", str(ref / "2b"), "--device", "cuda"])):
                t0 = time.time()
                rc = main(argv)
                walls[name] = time.time() - t0
                check(rc == 0, f"phase 34: {name} exited {rc}")
            files = sorted(str(p.relative_to(out)) for p in out.rglob("*")
                           if p.is_file())
            check(files == sorted(list(expected) + [
                f"{f}/fit_params.json" for f in ("1b", "2b", "3b")]),
                f"phase 34: the CLIs wrote {files}")
            cols = {}
            for name, (header, rows) in expected.items():
                c = read_columns(out / name)
                check(list(c) == header
                      and all(len(v) == rows for v in c.values()),
                      f"phase 34: {name}: columns {list(c)}, rows "
                      f"{[len(v) for v in c.values()]}")
                check(all(bool(np.isfinite(v).all()) for v in c.values()),
                      f"phase 34: {name} holds a non-finite value")
                cols[name] = c
            fitted = {f: json.loads((out / f / "fit_params.json").read_text())
                      for f in ("1b", "2b", "3b")}

            # eval_latent at the script's scale, on the CLI's own features
            p = fitted["1b"]["1b_2"]["z"]
            te = read_columns(ref / "1b" / "1b_2_test.csv")
            tr = np.random.default_rng(SYNTH_SEED + 100 * 2).uniform(
                size=(n_tr1, 2))
            check(np.array_equal(cols["1b/1b_2.csv"]["x"], tr[:, 0]),
                  "phase 34: 1b_2's train sites are not the script's draw")
            xy = np.vstack([tr, np.column_stack([te["x"], te["y"]])])
            om, ph = s13.matern_rff(p, SYNTH_M, SYNTH_SEED + 7 * 2)
            lat = s13.eval_latent(xy, om, ph, device="cuda")
            ms = []
            for _ in range(SYNTH_LATENT_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                again = s13.eval_latent(xy, om, ph, device="cuda")
                ms.append(1e3 * (time.perf_counter() - t0))
                check(np.array_equal(again, lat),
                      "phase 34: two calls of eval_latent differ")
            lo, hi = SYNTH_LATENT_STD
            check(lo < lat.std() < hi, f"phase 34: the latent's std "
                  f"{lat.std():.4f} is outside ({lo}, {hi})")
            z = s13.sample_field(p, lat, SYNTH_SEED + 11 * 2).astype(
                np.float32)
            check(np.array_equal(cols["1b/1b_2.csv"]["z"].astype(np.float32),
                                 z[:n_tr1])
                  and np.array_equal(cols["1b/1b_2_synthsol.csv"]["z"]
                                     .astype(np.float32), z[n_tr1:]),
                  "phase 34: the CLI's 1b_2 values are not sample_field of "
                  "this latent")
            idx = np.random.default_rng(35).choice(len(xy), SYNTH_F64_POINTS,
                                                   replace=False)
            f64 = np.sqrt(2.0 / SYNTH_M) * np.cos(xy[idx] @ om.T + ph).sum(1)
            gap = float(np.abs(lat[idx] - f64).max())
            check(gap <= SYNTH_F64_BAR, f"phase 34: eval_latent is "
                  f"{gap:.3e} from float64 (bar {SYNTH_F64_BAR})")
            print(f"synthesize: eval_latent at n={len(xy)}, m={SYNTH_M} on "
                  f"the card: " + ", ".join(f"{t:.3f}" for t in ms)
                  + f" ms (median {sorted(ms)[len(ms) // 2]:.3f}); latent "
                  f"mean {lat.mean():.4f} std {lat.std():.4f}; max |d| to "
                  f"float64 at {SYNTH_F64_POINTS} points {gap:.3e} (bar "
                  f"{SYNTH_F64_BAR}); |omega| up to "
                  f"{np.abs(om).max():.1f}", flush=True)

            gen_2b = json.loads((REPO / "data/2b/fit_params.json")
                                .read_text())
            pairs = [("1b_2", gen["1b_2"], p),
                     ("3b_1.z1", gen["3b_1.z1"], fitted["3b"]["3b_1"]["z1"]),
                     ("3b_1.z2", gen["3b_1.z2"], fitted["3b"]["3b_1"]["z2"]),
                     ("2b (bench field)", gen_2b, fitted["2b"])]
            for name, g, f in pairs:
                print(f"synthesize: {name} refitted range {f['range_']:.4f} "
                      f"sill {f['sigma2']:.4f} nugget {f['nugget']:.4f}; "
                      f"generating {g['range_']:.4f} / {g['sigma2']:.4f} / "
                      f"{g['nugget']:.4f}", flush=True)
            print(f"synthesize: 3b_1 measured rho "
                  f"{fitted['3b']['3b_1']['cross_corr']:.4f} (latents mixed "
                  f"at {SYNTH_3B_RHO})", flush=True)
            for name, g, f in pairs[:1] + ([pairs[3]] if self.data_file
                                          == standin_path() else []):
                check(0.5 * g["range_"] < f["range_"] < 2.0 * g["range_"]
                      and abs(f["sigma2"] - g["sigma2"]) < 0.3,
                      f"phase 34: {name} refitted {f} far from {g}")
        print("synthesize: " + ", ".join(f"{k} {v:.1f} s" for k, v
                                         in walls.items()), flush=True)

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
        (N, k, H, basis) that a counted run of the other phases launched it
        at, on seeded inputs: without a lane axis, and with one (M lanes,
        the basis kernels with a column mask where the launch had one)."""
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
                  f"(rtol, atol {BARS[nm]})", flush=True)
            lanes = [key for key in keys if key[0]]
            if not lanes:
                continue
            worst, shapes = 0.0, []
            for i, (lead, n, k, h, masked, bid) in enumerate(lanes):
                basis = basis_names[bid]
                kern, plain = self.lane_pair_at(nm, lead[0], n, k, h,
                                                masked, basis, 700 + i)
                where = (f"lane launch shape M={lead[0]} N={n} k={k} H={h} "
                         f"{basis}{' masked' if masked else ''}")
                worst = max(worst, self.hold(nm, kern, plain, where))
                shapes.append(f"{lead[0]}x{n}x{k}" + (f"x{h}" if h else "")
                              + (" masked" if masked else ""))
            print(f"  {nm}: held at {len(lanes)} lane launch shapes ("
                  + ", ".join(shapes) + f"), worst max |d| {worst:.3e}",
                  flush=True)

    def lane_pair_at(self, nm, lanes, n, k, h, masked, basis, seed):
        """(kernel call, plain call) of lane kernel `nm` on seeded inputs
        with `lanes` lanes at (n, k, h); the basis kernels with phase 7's
        column mask where the launch had one."""
        from st_dadk_tpu_torch.ops.basis import BASIS_IDS, CALIBRATION_FACTORS
        torch = self.torch
        bid, cal = BASIS_IDS[basis], CALIBRATION_FACTORS[basis]
        if nm in LANE_KERNELS:
            coords, centers, bw, w, grad_h = _lane_inputs(torch, lanes, n, k,
                                                          max(h, 1), seed)
            return _lane_calls(self.ffl, coords, centers,
                               (1.0 / (bw * cal)).contiguous(), w, grad_h,
                               bid, (nm,))[nm]
        coords, centers, bw, grad_phi, mask, _ = _basis_lane_inputs(
            torch, lanes, n, k, seed)
        return _basis_lane_calls(self.sbk, coords, centers,
                                 (1.0 / (bw * cal)).contiguous(), grad_phi,
                                 bid, mask if masked else None, (nm,))[nm]

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

    # -- phases 22-24: the fit's arithmetic options ----------------------------
    @staticmethod
    def per_step_ms(res):
        """ms a step of a single fit in epochs 2 onwards."""
        st = res["stage_timings"]
        per_epoch = res["n_steps"] // res["n_epochs_run"]
        return 1e3 * ((st["train_steps_seconds"]
                       - st["first_epoch_steps_seconds"])
                      / (res["n_steps"] - per_epoch))

    def bf16_phase(self, bench, lane):
        """Phase 22: the bench fit and the ragged lane with the bf16 trunk,
        each against its float32 fit of phases 3 and 4."""
        for name, ref, out, over, kernels in (
                ("bench bf16", bench, "chip_smoke_fit_bf16", {},
                 ("fused_first_layer_fwd", "fused_first_layer_bwd_w",
                  "fused_first_layer_bwd_centers")),
                ("ragged lane bf16", lane, "chip_smoke_ragged_bf16",
                 dict(k_spatial_centers=LANE_CENTERS,
                      k_spatial_pad=LANE_PAD),
                 ("spatial_basis_fwd", "spatial_basis_bwd_centers"))):
            _, res, counts, _ = self.fit(name, REPO / "build" / out,
                                         train_dtype="bf16", **over)
            self.option_launches[name] = counts
            expect_fwd = self.expected_fwd(res)
            check(counts[kernels[0]] == expect_fwd,
                  f"{name}: {kernels[0]} launches {counts[kernels[0]]} != "
                  f"steps + validations + predict chunks = {expect_fwd}")
            for nm in kernels[1:]:
                check(counts[nm] == res["n_steps"], f"{name}: {nm} launches "
                      f"{counts[nm]} != steps {res['n_steps']}")
            for nm, c in counts.items():
                if nm not in kernels:
                    check(c == 0, f"{name}: {nm} launched {c} times")
            f32 = ref[1]
            for key in ("test_rmse", "valid_rmse"):
                d = abs(res[key] - f32[key])
                print(f"{name}: {key} {res[key]!r} against float32 "
                      f"{f32[key]!r}, |d| {d:.3e} (bar {BF16_RMSE_BAR})",
                      flush=True)
                check(d < BF16_RMSE_BAR, f"{name}: {key} is {d:.3e} from "
                      f"the float32 fit's (bar {BF16_RMSE_BAR})")
            print(f"{name}: {self.per_step_ms(res):.3f} ms a step in epochs "
                  f"2-{EPOCHS}, float32 {self.per_step_ms(f32):.3f}",
                  flush=True)

    def nudged_drift(self, bench):
        """The drift rule's reference (phase 6): the bench fit with W_s one
        ulp up, its loss histories' relative gap to phase 3's by epoch."""
        import numpy as np

        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.config import ExperimentConfig
        from st_dadk_tpu_torch.train import loop
        from st_dadk_tpu_torch.train.experiment import ExperimentSetup

        if getattr(self, "_drift", None) is None:
            cfg = ExperimentConfig.from_dict(bench_workload(
                data_file=str(self.data_file), epochs=EPOCHS))
            setup = ExperimentSetup(cfg, 1, "cuda")
            with self.torch.no_grad():
                w = setup.model.mlp.linear_0.w
                w.copy_(self.torch.nextafter(w, self.torch.full_like(w, 10.0)))
            nudged = loop.fit(cfg, setup.spec, setup.model, setup.train_ps,
                              setup.valid_ps, seed=setup.experiment_seed)
            hist = bench[1]["training_history"]
            self._drift = {
                key: np.abs(np.asarray(nudged.history[key])
                            - np.asarray(hist[key])) / np.abs(hist[key])
                for key in ("train_loss", "val_loss")}
            print("drift of the bench fit with W_s one ulp up: " + "; ".join(
                f"{k} " + " ".join(f"{g:.1e}" for g in v)
                for k, v in self._drift.items()), flush=True)
        return self._drift

    def reordered_drift(self):
        """Phase 25's reference: the bench fit with every minibatch's rows,
        and its dropout block's rows with them, in reverse order. The same
        arithmetic on the same pairs of point and mask, with every sum over
        the points in another order, which is what the data-parallel split
        changes in every step; its loss histories' relative gap to the
        straight fit's (phase 3's) by epoch."""
        from st_dadk_tpu_torch.bench_workload import bench_workload

        if getattr(self, "_reordered", None) is None:
            self._reordered = self.reordered_drift_of(
                "the bench fit", bench_workload(data_file=str(self.data_file),
                                                epochs=EPOCHS))
        return self._reordered

    def reordered_drift_of(self, name, cfg):
        """`reordered_drift`'s reference for another config (a dict):
        experiment 1 of `cfg` fitted straight and with every minibatch's
        rows (and dropout rows) reversed, the relative gap of their loss
        histories by epoch."""
        import numpy as np

        from st_dadk_tpu_torch.config import ExperimentConfig
        from st_dadk_tpu_torch.models.st_interp import STInterp
        from st_dadk_tpu_torch.train import loop
        from st_dadk_tpu_torch.train.experiment import ExperimentSetup

        cfg = ExperimentConfig.from_dict(cfg)
        fits = []
        for flip in (False, True):
            setup = ExperimentSetup(cfg, 1, "cuda")
            indices, keep = loop.epoch_batch_indices, STInterp.draw_dropout_keep
            if flip:
                loop.epoch_batch_indices = lambda *a: indices(*a).flip(1)
                STInterp.draw_dropout_keep = lambda m, *a: keep(m, *a).flip(0)
            try:
                fits.append(loop.fit(cfg, setup.spec, setup.model,
                                     setup.train_ps, setup.valid_ps,
                                     seed=setup.experiment_seed).history)
            finally:
                loop.epoch_batch_indices = indices
                STInterp.draw_dropout_keep = keep
        drift = {key: np.abs(np.asarray(fits[1][key]) - fits[0][key])
                 / np.abs(fits[0][key]) for key in ("train_loss", "val_loss")}
        print(f"drift of {name} with its minibatch rows reversed: "
              + "; ".join(f"{k} " + " ".join(f"{g:.1e}" for g in v)
                          for k, v in drift.items()), flush=True)
        return drift

    def hold_by_drift(self, name, got, want, drift, scores=True):
        """Histories of `got` against `want` (results.json dicts): the
        early bar in epochs 1-LANE_EARLY_EPOCHS, then LANE_DRIFT_FACTOR x
        the running maximum of `drift`; with `scores`, the scores at the
        same factor of its largest value."""
        import numpy as np

        worst = 0.0
        for key in ("train_loss", "val_loss"):
            a = np.asarray(got["training_history"][key])
            b = np.asarray(want["training_history"][key])
            check(len(a) == len(b), f"{name}: {key} has {len(a)} epochs, "
                  f"the reference {len(b)}")
            gaps = np.abs(a - b) / np.abs(b)
            # past the reference's epochs, its largest drift
            d = np.maximum.accumulate(drift[key])
            d = np.concatenate([d, np.full(max(len(gaps) - len(d), 0),
                                           d[-1])])[:len(gaps)]
            bar = np.maximum(LANE_EARLY_RTOL, LANE_DRIFT_FACTOR * d)
            bar[:LANE_EARLY_EPOCHS] = LANE_EARLY_RTOL
            print(f"  {name}, {key}, relative gap by epoch: "
                  + " ".join(f"{g:.1e}" for g in gaps) + "; bar: "
                  + " ".join(f"{g:.1e}" for g in bar), flush=True)
            over = np.maximum.accumulate(gaps) > bar
            check(not over.any(), f"{name}: {key} is {gaps.max():.3e} from "
                  f"the reference, past its bar from epoch "
                  f"{int(np.argmax(over)) + 1}")
            worst = max(worst, float(gaps.max()))
        score_bar = max(LANE_SCORE_RTOL, LANE_DRIFT_FACTOR * max(
            float(v.max()) for v in drift.values()))
        for key in LANE_SCORES if scores else ():
            gap = abs(got[key] - want[key]) / abs(want[key])
            check(gap <= score_bar, f"{name}: {key} {got[key]!r} is "
                  f"{gap:.3e} from {want[key]!r} (bar {score_bar:.1e})")
        return worst

    def activities_per_step(self, packed, lanes):
        """Device activities a step (validation included) of a
        PACKED_PROFILE_EPOCHS-epoch bench fit, or of a batch of `lanes`
        lanes, under torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.config import ExperimentConfig
        from st_dadk_tpu_torch.models.st_interp import stack_lane_models
        from st_dadk_tpu_torch.profile_fit import _device_profile
        from st_dadk_tpu_torch.train import batch_engine as be
        from st_dadk_tpu_torch.train import loop
        from st_dadk_tpu_torch.train.experiment import ExperimentSetup

        torch = self.torch
        cfg = ExperimentConfig.from_dict(bench_workload(
            data_file=str(self.data_file), epochs=PACKED_PROFILE_EPOCHS,
            packed_optimizer=packed))
        setups = [ExperimentSetup(cfg, i + 1, "cuda") for i in range(lanes)]
        if lanes == 1:
            s = setups[0]
            run = lambda: loop.fit(cfg, s.spec, s.model, s.train_ps,
                                   s.valid_ps, seed=s.experiment_seed)
        else:
            stacked = be._stack_lane_host(cfg, setups,
                                          torch.device("cuda"))
            model = stack_lane_models([s.model for s in setups])
            run = lambda: loop.fit_lanes(
                cfg, setups[0].spec, model, stacked["data"],
                stacked["lr_steps"], stacked["lr_recorded"],
                [s.experiment_seed for s in setups])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = run()
            torch.cuda.synchronize()
        steps = (res.n_steps if lanes == 1
                 else int(res[0].timings["steps_per_epoch_batch"])
                 * int(res[0].timings["epochs_run_batch"]))
        d = _device_profile(prof, steps)
        return d["activities"] / steps, d["device_ms"] / steps

    def packed_phase(self, bench):
        """Phase 23: the bench fit and phase 6's 4-lane batch with the
        packed optimizer against the unpacked runs of phases 3 and 6."""
        import shutil

        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.train.runner import (load_all_results,
                                                    run_multiple_experiments)

        drift = self.nudged_drift(bench)
        _, res, counts, _ = self.fit("bench packed",
                                     REPO / "build" / "chip_smoke_fit_packed",
                                     packed_optimizer=True)
        self.option_launches["bench packed"] = counts
        check(counts == self.bench_counts, f"bench packed: launches {counts}"
              f" != the unpacked fit's {self.bench_counts}")
        worst = self.hold_by_drift("bench packed", res, bench[1], drift)
        print(f"bench packed against phase 3: loss histories within "
              f"{worst:.3e} relative; test RMSE {res['test_rmse']!r} / "
              f"{bench[1]['test_rmse']!r}; {self.per_step_ms(res):.3f} ms a "
              f"step, unpacked {self.per_step_ms(bench[1]):.3f}", flush=True)

        out = REPO / "build" / "chip_smoke_lanes_packed"
        shutil.rmtree(out, ignore_errors=True)
        cfg = bench_workload(data_file=str(self.data_file), epochs=EPOCHS,
                             n_experiments=LANES, save_artifacts=True,
                             packed_optimizer=True)
        _, counts = self.counted(lambda: run_multiple_experiments(
            cfg, out, engine="vmap", device="cuda"))
        self.option_launches["4 lanes packed"] = counts
        check(counts == self.lane_counts, f"4 lanes packed: launches "
              f"{counts} != the unpacked batch's {self.lane_counts}")
        packed = load_all_results(out / "experiments", LANES)
        check(len(packed) == LANES, f"{len(packed)} of {LANES} packed lanes")
        for i, (a, b) in enumerate(zip(packed, self.lanes_results)):
            w = self.hold_by_drift(f"packed lane {i + 1}", a, b, drift)
            print(f"packed lane {i + 1} against phase 6's: histories within "
                  f"{w:.3e}; test RMSE {a['test_rmse']!r} / "
                  f"{b['test_rmse']!r}", flush=True)
        for lanes in (1, LANES):
            (u, u_ms), (p, p_ms) = (self.activities_per_step(False, lanes),
                                    self.activities_per_step(True, lanes))
            print(f"{'bench fit' if lanes == 1 else f'{lanes} lanes'}: "
                  f"device activities a step (validation included) unpacked "
                  f"{u:.1f}, packed {p:.1f}; device ms a step {u_ms:.4f} / "
                  f"{p_ms:.4f} (profiled, {PACKED_PROFILE_EPOCHS} epochs)",
                  flush=True)
            check(p < u, f"the packed step launches no fewer device "
                  f"activities ({p:.1f} against {u:.1f})")

    def compaction_phase(self):
        """Phase 24: COMPACT_LANES lanes at patience 1, compacted against
        the same batch uncompacted."""
        import contextlib
        import io
        import shutil

        from st_dadk_tpu_torch.bench_workload import bench_workload
        from st_dadk_tpu_torch.train.runner import (load_all_results,
                                                    run_multiple_experiments)

        drift = self._drift
        runs = {}
        for compact in (False, True):
            out = REPO / "build" / f"chip_smoke_compact_{int(compact)}"
            shutil.rmtree(out, ignore_errors=True)
            cfg = bench_workload(data_file=str(self.data_file),
                                 epochs=COMPACT_EPOCHS, patience=1,
                                 early_stop_min_rel_delta=COMPACT_MIN_GAIN,
                                 n_experiments=COMPACT_LANES,
                                 save_artifacts=False,
                                 tail_compaction=compact,
                                 compaction_epoch=COMPACT_EVERY)
            log = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(log):
                _, counts = self.counted(lambda: run_multiple_experiments(
                    cfg, out, engine="vmap", device="cuda", verbose=True))
            wall = time.time() - t0
            lines = [ln for ln in log.getvalue().splitlines()
                     if "tail compaction" in ln]
            runs[compact] = (load_all_results(out / "experiments",
                                              COMPACT_LANES), lines, wall)
            self.option_launches["compaction" if compact
                                 else "patience 1"] = counts
            res = runs[compact][0]
            print(f"{'compacted' if compact else 'full width'}: "
                  f"{len(res)} lanes in {wall:.1f} s, stop epochs "
                  f"{[r['n_epochs_run'] for r in res]}, fused forward "
                  f"launches {counts['fused_first_layer_fwd']}", flush=True)
            for ln in lines:
                print(f"  {ln.strip()}", flush=True)
        full, (comp, lines, _) = runs[False][0], runs[True]
        check(len(full) == len(comp) == COMPACT_LANES,
              f"{len(full)} / {len(comp)} of {COMPACT_LANES} lanes finished")
        check(len(lines) == 1, f"the batch narrowed {len(lines)} times, "
              f"not once")
        check(not runs[False][1], "the uncompacted batch narrowed")
        for i, (a, b) in enumerate(zip(comp, full)):
            check(a["n_epochs_run"] == b["n_epochs_run"],
                  f"compacted lane {i + 1} stopped at epoch "
                  f"{a['n_epochs_run']}, uncompacted at {b['n_epochs_run']}")
            w = self.hold_by_drift(f"compacted lane {i + 1}", a, b, drift)
            print(f"compacted lane {i + 1}: histories within {w:.3e} of the "
                  f"uncompacted lane's", flush=True)

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


def _rank_runs(rank, data_file, root):
    """Phases 25 (ii)-27 on one gloo rank of the card (`Phases.two_ranks`):
    the bench fit data-parallel, fit_tp, and the lane CLI; each run with
    the kernels' launch counts and shapes, reset just before it."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from st_dadk_tpu_torch.bench_workload import bench_workload
    from st_dadk_tpu_torch.cli import train_st_interp as cli
    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.models.st_interp import model_consts, to_jax_params
    from st_dadk_tpu_torch.ops import fused_first_layer as ffl
    from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
    from st_dadk_tpu_torch.parallel.multihost import local_device
    from st_dadk_tpu_torch.parallel.tensor_parallel import fit_tp
    from st_dadk_tpu_torch.train import batch_engine, experiment
    from st_dadk_tpu_torch.train.runner import run_multiple_experiments

    def counted(fn):
        ffl.reset_launch_counts()
        sbk.reset_launch_counts()
        torch.cuda.synchronize()
        got = fn()
        torch.cuda.synchronize()
        return got, {"counts": {**ffl.launch_counts(), **sbk.launch_counts()},
                     "shapes": {**ffl.launch_shapes(), **sbk.launch_shapes()}}

    out, seen, written = {}, {}, []
    for mod in (batch_engine, experiment):
        orig = mod.finalize_experiment

        def record(cfg_, setup, result, *a, _orig=orig, **kw):
            seen["params"] = experiment._flatten_params(result.params)
            if kw.get("write_artifacts", True):
                written.append(setup.experiment_id)
            return _orig(cfg_, setup, result, *a, **kw)
        mod.finalize_experiment = record

    bench = bench_workload(data_file=data_file, epochs=EPOCHS,
                           save_artifacts=True, n_experiments=1)
    _, out["dp"] = counted(lambda: run_multiple_experiments(
        bench, f"{root}/dp", engine="dp"))
    out["dp"]["params"] = seen["params"]

    cfg = ExperimentConfig.from_dict(bench)
    setup = experiment.ExperimentSetup(cfg, 1, local_device())
    state = {}
    res, out["tp"] = counted(lambda: fit_tp(
        cfg, setup.spec, to_jax_params(setup.model),
        model_consts(setup.model), setup.train_ps, setup.valid_ps,
        seed=setup.experiment_seed, state_out=state))
    model = state["model"]
    pad = ~model.row_valid
    pads = {n: p.detach()[pad].cpu() for n, p in model.sharded().items()}
    out["tp"].update(
        training_history={k: v.tolist() for k, v in res.history.items()},
        n_epochs_run=res.n_epochs_run, pad_rows=int(pad.sum()),
        pads_inert=bool((pads["mlp.w0_spatial"] == 0).all()
                        and (pads["basis.centers"] == 0.5).all()
                        and (pads["basis.log_bandwidths"] == 0).all()
                        and np.isfinite(res.best_val)))

    written.clear()
    summary, out["lanes"] = counted(lambda: cli.main(
        ["--config", f"{root}/lanes.yaml", "--engine", "vmap",
         "--output_dir", f"{root}/lanes"]))
    out["lanes"].update(written=sorted(set(written)),
                        summary=summary is not None)
    return out


def _nested_runs(rank, runs):
    """Phase 29 on one gloo rank of the card: for each (config path, output
    directory) of `runs`, its lanes through `run_job_batch` over a
    NESTED_MESH mesh, with the kernels' launch counts and shapes reset
    just before it; the lanes this rank owns and those it wrote."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.ops import fused_first_layer as ffl
    from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
    from st_dadk_tpu_torch.parallel.mesh import make_mesh
    from st_dadk_tpu_torch.parallel.multihost import local_device
    from st_dadk_tpu_torch.train import batch_engine

    mesh = make_mesh(dict(NESTED_MESH))
    written = []
    orig = batch_engine.finalize_experiment

    def record(cfg_, setup, result, *a, **kw):
        written.append(setup.experiment_id)
        return orig(cfg_, setup, result, *a, **kw)
    batch_engine.finalize_experiment = record
    out = []
    for cfg_path, out_dir in runs:
        cfg = ExperimentConfig.from_yaml(cfg_path)
        jobs = [(cfg, i, Path(out_dir) / "experiments" / str(i))
                for i in range(1, cfg.n_experiments + 1)]
        owned = batch_engine.owned_lane_slice(len(jobs), mesh)
        written.clear()
        ffl.reset_launch_counts()
        sbk.reset_launch_counts()
        torch.cuda.synchronize()
        batch_engine.run_job_batch(jobs, mesh=mesh, device=local_device())
        torch.cuda.synchronize()
        out.append({"lanes": list(range(owned.start + 1, owned.stop + 1)),
                    "written": sorted(written),
                    "counts": {**ffl.launch_counts(),
                               **sbk.launch_counts()},
                    "shapes": {**ffl.launch_shapes(),
                               **sbk.launch_shapes()}})
    return out


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
