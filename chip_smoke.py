#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (st_dadk_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # full run (needs one CUDA card)
    python3 chip_smoke.py --kernels-only  # build + check + time the kernels

Phases, each of which fails the run (non-zero exit, no result line):
  1. build the CUDA kernels from st_dadk_tpu_torch/csrc with nvcc;
  2. hold each kernel against its plain PyTorch version on the card, at the
     fit's shapes and a ragged one, for all three bases and a center lying
     exactly on a point; time kernel and plain version;
  3. run the bench-workload DA-STDK fit (12 epochs, basis unfreezing at
     epoch 10) through `run_single_experiment`, counting kernel launches,
     then check the losses, the centers and the test metrics.
The last line of standard output is one JSON object with "ok" and the
device; the line before it lists the kernels.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SOURCE = "st_dadk_tpu_torch/csrc/fused_first_layer.cu"
REPLACES = {
    "fused_first_layer_fwd": "st_dadk_tpu/ops/pallas_fused.py:48",
    "fused_first_layer_bwd_w": "st_dadk_tpu/ops/pallas_fused.py:129",
    "fused_first_layer_bwd_centers": "st_dadk_tpu/ops/pallas_fused.py:170",
}
# fit shapes: training step (N=512), validation (N=2000), predict chunk
# (N=32768) at k=227 bench centers and H=256 first hidden width
SLICE_SHAPES = [(512, 227, 256), (2000, 227, 256), (32768, 227, 256)]
RAGGED_SHAPE = (200, 106, 48)
# the basis unfreezes at epoch 10 of the bench workload: 12 epochs train the
# centers for two
EPOCHS = 12
FWD_ATOL = 1e-4                 # tests/test_pallas_fused.py:40
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5   # tests/test_pallas_fused.py:92


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
    g = torch.Generator().manual_seed(seed)
    coords = torch.rand((n, 2), generator=g)
    centers = torch.rand((k, 2), generator=g)
    if zero_distance:
        m = min(n, k)
        coords[:m] = centers[:m]
    bw = 0.1 + 0.7 * torch.rand((k,), generator=g)
    w = 0.1 * torch.randn((k, h), generator=g)
    # the gradient of a mean loss: O(1/N) per point
    grad = torch.randn((n, h), generator=g) / n
    dev = torch.device("cuda")
    return [t.to(dev) for t in (coords, centers, bw, w, grad)]


def _err(torch, got, want, rtol, atol):
    """(max abs error, worst |got-want| - (atol + rtol |want|))."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff - atol - rtol * want.abs()).max())


def _time_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(torch, ffl, basis_ids, cal):
    """Check every kernel against its plain version; time both."""
    names = list(REPLACES)
    # create the cuBLAS handle on this thread before autograd's device
    # thread needs one in the plain backward
    torch.ones((2, 2), device="cuda") @ torch.ones((2, 2), device="cuda")
    worst = {nm: 0.0 for nm in names}
    times = {}
    cases = [(s, b, False) for s in SLICE_SHAPES + [RAGGED_SHAPE]
             for b in basis_ids] + [(RAGGED_SHAPE, b, True) for b in basis_ids]
    for i, ((n, k, h), basis, zero) in enumerate(cases):
        coords, centers, bw, w, grad = _inputs(torch, n, k, h, seed=i,
                                               zero_distance=zero)
        bid = basis_ids[basis]
        inv_bw = (1.0 / (bw * cal[basis])).contiguous()
        got = {
            "fused_first_layer_fwd": ffl.fused_first_layer_fwd(
                coords, centers, inv_bw, w, bid),
            "fused_first_layer_bwd_w": ffl.fused_first_layer_bwd_w(
                coords, centers, inv_bw, grad, bid),
        }
        got["fused_first_layer_bwd_centers"] = \
            ffl.fused_first_layer_bwd_centers(coords, centers, inv_bw, w,
                                              grad, bid)
        torch.cuda.synchronize()
        want = {
            "fused_first_layer_fwd": ffl.plain_fwd(coords, centers, inv_bw,
                                                   w, bid),
            "fused_first_layer_bwd_w": ffl.plain_bwd_w(coords, centers,
                                                       inv_bw, grad, bid),
            "fused_first_layer_bwd_centers": ffl.plain_bwd_centers(
                coords, centers, inv_bw, w, grad, bid),
        }
        line = [f"n={n} k={k} h={h} {basis}{' zero-distance' if zero else ''}:"]
        for nm in names:
            gs = got[nm] if isinstance(got[nm], tuple) else (got[nm],)
            ws = want[nm] if isinstance(want[nm], tuple) else (want[nm],)
            rtol, atol = ((0.0, FWD_ATOL) if nm.endswith("fwd")
                          else (GRAD_RTOL, GRAD_ATOL))
            for a, b in zip(gs, ws):
                check(bool(torch.isfinite(a).all()),
                      f"{nm}: non-finite output at {line[0]}")
                mx, excess = _err(torch, a, b, rtol, atol)
                worst[nm] = max(worst[nm], mx)
                line.append(f"{nm.replace('fused_first_layer_', '')} "
                            f"max|d|={mx:.3e}")
                check(excess <= 0.0,
                      f"{nm} disagrees with its plain version at {line[0]} "
                      f"(max |d| {mx:.3e}, rtol {rtol}, atol {atol})")
        print("  " + " ".join(line), flush=True)

    print("kernel times on the card (CUDA events, mean of 20 launches):")
    for (n, k, h) in SLICE_SHAPES:
        coords, centers, bw, w, grad = _inputs(torch, n, k, h, seed=99)
        inv_bw = (1.0 / bw).contiguous()
        bid = basis_ids["wendland"]
        pairs = {
            "fused_first_layer_fwd": (
                lambda: ffl.fused_first_layer_fwd(coords, centers, inv_bw,
                                                  w, bid),
                lambda: ffl.plain_fwd(coords, centers, inv_bw, w, bid)),
            "fused_first_layer_bwd_w": (
                lambda: ffl.fused_first_layer_bwd_w(coords, centers, inv_bw,
                                                    grad, bid),
                lambda: ffl.plain_bwd_w(coords, centers, inv_bw, grad, bid)),
            "fused_first_layer_bwd_centers": (
                lambda: ffl.fused_first_layer_bwd_centers(
                    coords, centers, inv_bw, w, grad, bid),
                lambda: ffl.plain_bwd_centers(coords, centers, inv_bw, w,
                                              grad, bid)),
        }
        for nm, (kern, plain) in pairs.items():
            # plain, kernel, kernel, plain: the pairs see the same card state
            p1 = _time_ms(torch, plain)
            k1 = _time_ms(torch, kern)
            k2 = _time_ms(torch, kern)
            p2 = _time_ms(torch, plain)
            times[(nm, n)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"  {nm:31s} N={n:6d} k={k} H={h}: kernel "
                  f"{times[(nm, n)][0]:.4f} ms  plain {times[(nm, n)][1]:.4f}"
                  f" ms", flush=True)
    return worst, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true")
    args = ap.parse_args(argv)

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
    from st_dadk_tpu_torch.ops.basis import BASIS_IDS, CALIBRATION_FACTORS

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.time()
    lib = _build.build("fused_first_layer", verbose=True)
    print(f"built {lib.name} in {time.time() - t0:.1f} s", flush=True)

    worst, times = kernel_phase(torch, ffl, BASIS_IDS, CALIBRATION_FACTORS)
    launches = {nm: None for nm in REPLACES}
    if not args.kernels_only:
        launches = fit_phase(torch, ffl, EPOCHS)

    step_n = SLICE_SHAPES[0][0]
    report = {"kernels": [
        {"name": nm, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[nm], "launches": launches[nm],
         "max_abs_err": worst[nm], "ms": times[(nm, step_n)][0],
         "plain_ms": times[(nm, step_n)][1], "shape_of_ms": list(
             SLICE_SHAPES[0])}
        for nm in REPLACES]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def fit_phase(torch, ffl, epochs):
    """The bench-workload fit through run_single_experiment; returns the
    launch counts of that run."""
    import numpy as np

    from st_dadk_tpu_torch.bench_workload import bench_workload
    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.dataio.synthetic import bench_data_file
    from st_dadk_tpu_torch.models.st_interp import (from_jax_params,
                                                    spec_from_config)
    from st_dadk_tpu_torch.train.experiment import (load_params_npz,
                                                    run_single_experiment)
    from st_dadk_tpu_torch.train.loop import n_predict_chunks, predict

    t0 = time.time()
    data_file = bench_data_file()
    print(f"data: {data_file.relative_to(REPO)} ({time.time() - t0:.1f} s)",
          flush=True)
    cfg = bench_workload(data_file=str(data_file), epochs=epochs,
                         save_artifacts=True)
    out_dir = REPO / "build" / "chip_smoke_fit"
    print(f"fit: bench workload, {epochs} epochs, basis unfreezes at epoch "
          f"{cfg['basis_unfreeze_epoch']}", flush=True)

    ffl.reset_launch_counts()
    torch.cuda.synchronize()
    res = run_single_experiment(cfg, 1, out_dir, device="cuda", verbose=True)
    torch.cuda.synchronize()
    launches = ffl.launch_counts()

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
          f"2-{n_ep} {1e3 * rest / (steps - per_epoch):.3f} ms", flush=True)
    print(f"test RMSE {res['test_rmse']:.6f}  test CRPS {res['test_crps']:.6f}"
          f"  (valid RMSE {res['valid_rmse']:.6f} CRPS "
          f"{res['valid_crps']:.6f})", flush=True)
    print("launches: " + json.dumps(launches), flush=True)

    pts = res["n_points"]
    expect_fwd = (steps + n_ep * res["n_val_chunks"]
                  + sum(n_predict_chunks(pts[s]) for s in
                        ("train", "valid", "test", "dense") if pts[s]))
    for nm, c in launches.items():
        check(c > 0, f"{nm} was never launched by the fit")
    check(launches["fused_first_layer_fwd"] == expect_fwd,
          f"forward launches {launches['fused_first_layer_fwd']} != steps + "
          f"validations + predict chunks = {expect_fwd}")
    for nm in ("fused_first_layer_bwd_w", "fused_first_layer_bwd_centers"):
        check(launches[nm] == steps, f"{nm} launches {launches[nm]} != "
              f"steps {steps}")
    tl = np.asarray(hist["train_loss"])
    vl = np.asarray(hist["val_loss"])
    check(n_ep == epochs, f"the fit stopped after {n_ep} of {epochs} epochs")
    check(bool(np.all(np.isfinite(tl)) and np.all(np.isfinite(vl))),
          "non-finite loss in the history")
    check(tl[-1] < tl[0], f"train loss did not fall: {tl[0]} -> {tl[-1]}")
    shift = np.asarray(res["basis_center_shift"])
    unfreeze = cfg["basis_unfreeze_epoch"]
    check(bool(np.all(shift[:unfreeze] == 0.0)),
          f"centers moved while frozen: {shift[:unfreeze]}")
    check(shift[-1] > 0.0, "centers did not move after the unfreeze epoch")
    check(bool(np.isfinite(res["test_rmse"]) and np.isfinite(res["test_crps"])),
          "non-finite test metrics")

    # the dense field the fit predicted through the kernels, against the
    # plain PyTorch forward on the CPU from the saved params
    params = load_params_npz(out_dir / "model_final.npz")
    bi = np.load(out_dir / "basis_info.npz")
    dense = np.load(out_dir / "predictions.npz")
    pred = dense["predictions"]
    consts = {"spatial_centers_init": bi["spatial_centers_init"],
              "spatial_bandwidths_init": bi["spatial_bandwidths_init"]}
    spec = spec_from_config(ExperimentConfig.from_dict(cfg))
    cpu_model = from_jax_params(spec, params, consts, device="cpu")
    T, S = pred.shape
    rng = np.random.default_rng(0)
    tt = rng.integers(0, T, 2000)
    ss = rng.integers(0, S, 2000)
    coords = dense["coords"][ss]
    t_norm = (tt / (T - 1)).astype(np.float32)[:, None]
    mid = len(cfg["quantile_levels"]) // 2
    want = predict(cpu_model, coords, t_norm)[:, mid]
    err = float(np.max(np.abs(pred[tt, ss] - want)))
    print(f"dense prediction vs plain CPU forward on 2000 points: max |d| "
          f"{err:.3e}", flush=True)
    check(err <= 1e-4, f"dense prediction disagrees with the plain CPU "
          f"forward (max |d| {err:.3e} > 1e-4)")
    return launches


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
