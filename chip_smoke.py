#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (st_dadk_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # full run (needs one CUDA card)
    python3 chip_smoke.py --kernels-only  # build + check + time the kernels

Phases, each of which fails the run (non-zero exit, no result line):
  1. build the two CUDA libraries from st_dadk_tpu_torch/csrc with nvcc,
     one nvcc process each, both at once;
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
     the same replay;
  3. the bench-workload DA-STDK fit (12 epochs, basis unfreezing at epoch
     10) through `run_single_experiment`, on the fused route;
  4. a ragged-k lane of that workload (centers 25+81 padded to 227) through
     the materialised-phi kernels, and the same lane unpadded (fused route),
     whose test and valid RMSE it must match;
  5. the spatial gradient d yhat / d coords through both fitted models.
Each of phases 3-5 sets the launch counts to 0 just before it and reads
them just after; it checks the fit's losses, centers and test metrics. The
last line of standard output is one JSON object with "ok" and the device;
the line before it lists the kernels.
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
LANE_RMSE_BAR = 5e-3            # tests/test_ragged_k.py:171
GRAD_POINTS = 2000
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


def build_all(_build) -> None:
    """One nvcc process per library, both started together."""
    t0 = time.time()
    names = sorted({Path(src).stem for src, _ in KERNELS.values()})
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {nm: pool.submit(_build.build, nm, True) for nm in names}
        libs = {nm: f.result() for nm, f in futures.items()}
    print(f"built {', '.join(p.name for p in libs.values())} in "
          f"{time.time() - t0:.1f} s", flush=True)


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
    from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
    from st_dadk_tpu_torch.ops.basis import BASIS_IDS, CALIBRATION_FACTORS

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    build_all(_build)
    worst, times, floor = kernel_phase(torch, ffl, sbk, BASIS_IDS,
                                       CALIBRATION_FACTORS)
    launches = {nm: None for nm in KERNELS}
    if not args.kernels_only:
        launches = Phases(torch, ffl, sbk).run()

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
         "by_n": {str(n): times[(nm, n)] for n, _, _ in SLICE_SHAPES}}
        for nm, (src, replaces) in KERNELS.items()]}
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

    def counted(self, fn):
        """(fn(), launch counts of every kernel during fn)."""
        torch = self.torch
        self.ffl.reset_launch_counts()
        self.sbk.reset_launch_counts()
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
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
        self.lane_comparison(lane)
        self.spatial_gradients(bench, lane, launches)
        return launches

    def fit(self, name, out_dir, **overrides):
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
                cfg, 1, out_dir, device="cuda", verbose=True))
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
