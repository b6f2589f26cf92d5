"""Dense-inference throughput of the bench model on one GPU, by route
(counterpart of the JAX package's `scripts/bench_dense_inference.py`).

    python3 -m st_dadk_tpu_torch.bench_dense_inference [--n 131072] \\
        [--reps 30] [--out results/bench_torch/dense_inference.json] \\
        [--device cuda]

The model is the bench workload's at full width: spatial centers 25 + 81 +
121 (learnable Wendland basis), temporal centers 10 + 15 + 45, hidden
256-256-128 with LayerNorm and dropout 0.1, and a 5-quantile delta head,
its parameters drawn from a seeded `torch.Generator`; `n` uniform
coordinates and times come from `numpy.random.default_rng(0)`. Every call
is the inference forward (`train=False`: dropout draws nothing) of all `n`
points at once. Three arms compute it:

  plain       phi from `ops/basis.py::basis_matrix` and the first layer's
              product in PyTorch, then the model's trunk and head: the
              counterpart of the JAX script's jnp arm. On the card this runs
              the plain versions on CUDA tensors, which the port never does
              on its own; it is built here, not switched on in the model.
  phi_kernel  the materialised-phi route, `STInterp.forward(fused=False)`:
              phi from `csrc/spatial_basis.cu::fwd_kernel` (the JAX
              script's `pallas` arm).
  fused       the default route: `csrc/fused_first_layer.cu::fwd_kernel`,
              the counterpart of `pallas_fused.py::_fused_kernel`.

Before timing, the kernel arms are held to `plain` on the same inputs: the
first layer's output within H1_ATOL and the quantiles within OUT_ATOL.
Each arm's kernel launches are read from the wrappers' counters around one
call of its first layer and one of its forward: each kernel arm must launch
its kernel once a call and no other kernel, `plain` none (on the CPU the wrappers take their plain versions, so no arm
launches). A failed check raises; nothing falls back.

The protocol is the JAX script's: each arm warmed twice, then 3 trials
with the arms interleaved, the order reversed on odd trials, keeping each
arm's best trial. Throughput: `reps` calls queued and one barrier at the
end (`amortized_ms`, `mpts_per_s`); latency: one call and a barrier
(`latency_ms`). On the card the barrier is `torch.cuda.synchronize()` and
the host clock runs around work that ends in it; TF32 is off for PyTorch's
products, as in `profile_fit.py`. Each arm's peak device memory
(`max_memory_allocated` over one call, the model and inputs resident) is
recorded beside it. Writes `--out` (JSON): the device, each arm's numbers
and launches, the kernel arms' ratios to `plain` and the checks' worst
differences. The card is required unless `--device cpu` is passed (the
tests); a CPU run's numbers are no device metric.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from st_dadk_tpu_torch.models.st_interp import ModelSpec, STInterp, init_model
from st_dadk_tpu_torch.ops import fused_first_layer as ffl
from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
from st_dadk_tpu_torch.ops.basis import (CALIBRATION_FACTORS, basis_matrix,
                                         temporal_basis_embed)
from st_dadk_tpu_torch.utils.timing import device_record, require_device

REPO = Path(__file__).resolve().parents[1]
# the JAX script's model (scripts/bench_dense_inference.py:59-65)
BENCH_SPEC = ModelSpec(k_spatial_centers=(25, 81, 121),
                       k_temporal_centers=(10, 15, 45),
                       hidden_dims=(256, 256, 128), dropout=0.1,
                       spatial_learnable=True, output_dim=5,
                       use_delta_reparameterization=True)
ARMS = ("plain", "phi_kernel", "fused")
# the kernel each arm launches, once a call
ARM_KERNELS = {"plain": (), "phi_kernel": ("spatial_basis_fwd",),
               "fused": ("fused_first_layer_fwd",)}
TRIALS = 3
# the first layer's output: the fused forward's bar
# (tests/test_pallas_fused.py:40)
H1_ATOL = 1e-4
# the quantiles, after three layer norms: 10x the worst difference measured
# on an H100 80GB HBM3 at 700 W (the fused arm, 4.8e-7 at n = 131,072 and
# 4.0e-7 at 32,768)
OUT_ATOL = 5e-6


def bench_model(device: torch.device, seed: int = 0) -> STInterp:
    """The bench model (BENCH_SPEC) with parameters from a seeded
    generator, on `device`."""
    return init_model(torch.Generator().manual_seed(seed), BENCH_SPEC,
                      device=device).eval()


def dense_inputs(n: int, device: torch.device):
    """(coords (n, 2), t (n, 1)) float32, uniform, from default_rng(0)."""
    rng = np.random.default_rng(0)
    coords = torch.tensor(rng.uniform(size=(n, 2)), dtype=torch.float32)
    t = torch.tensor(rng.uniform(size=(n, 1)), dtype=torch.float32)
    return coords.to(device), t.to(device)


def plain_first_layer(model: STInterp, coords: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """The first layer's pre-norm output from the plain phi (the plain
    arm): [phi | psi] @ W + b."""
    basis = model.spec.spatial_basis_function
    centers, bandwidths = model.spatial_params()
    phi = basis_matrix(coords, centers,
                       1.0 / (bandwidths * CALIBRATION_FACTORS[basis]), basis)
    psi = temporal_basis_embed(t, model.temporal_centers,
                               model.temporal_bandwidths)
    lin0 = model.mlp.linear_0
    return torch.cat([phi, psi], dim=-1) @ lin0.w + lin0.b


def first_layer(model: STInterp, arm: str, coords: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    if arm == "plain":
        return plain_first_layer(model, coords, t)
    return model.first_layer(coords, t, None, fused=arm == "fused")


def arm_forward(model: STInterp, arm: str, coords: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """The (n, 5) quantiles of one arm; the kernel arms through
    `STInterp.forward`."""
    if arm == "plain":
        return model.head(model.trunk_from_h1(
            plain_first_layer(model, coords, t), False, None))
    return model(coords, t, fused=arm == "fused")


def _launches() -> Dict[str, int]:
    return {**ffl.launch_counts(), **sbk.launch_counts()}


def check_arms(model: STInterp, coords: torch.Tensor, t: torch.Tensor,
               device: torch.device) -> Dict[str, Any]:
    """Each kernel arm against `plain`: the first layer within H1_ATOL, the
    quantiles within OUT_ATOL, and the launches of one call of each arm
    (module docstring). Raises RuntimeError on any failure."""
    ref_h1 = plain_first_layer(model, coords, t)
    ref_out = arm_forward(model, "plain", coords, t)
    got: Dict[str, Any] = {"h1_atol": H1_ATOL, "out_atol": OUT_ATOL,
                           "h1_max_abs": {}, "out_max_abs": {},
                           "launches_a_call": {}}
    for arm in ARMS:
        before = _launches()
        h1 = first_layer(model, arm, coords, t)
        out = arm_forward(model, arm, coords, t)
        if device.type == "cuda":
            torch.cuda.synchronize()
        after = _launches()
        launched = {nm: after[nm] - before[nm] for nm in after
                    if after[nm] != before[nm]}
        got["launches_a_call"][arm] = launched
        # one call of the first layer and one of the forward
        want = ({nm: 2 for nm in ARM_KERNELS[arm]}
                if device.type == "cuda" else {})
        if launched != want:
            raise RuntimeError(f"{arm}: launches {launched}, expected {want}")
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{arm}: non-finite quantiles")
        if arm == "plain":
            continue
        d_h1 = float((h1 - ref_h1).abs().max())
        d_out = float((out - ref_out).abs().max())
        got["h1_max_abs"][arm], got["out_max_abs"][arm] = d_h1, d_out
        if not d_h1 <= H1_ATOL:
            raise RuntimeError(f"{arm}: first layer {d_h1:.3e} from plain "
                               f"(bar {H1_ATOL})")
        if not d_out <= OUT_ATOL:
            raise RuntimeError(f"{arm}: quantiles {d_out:.3e} from plain "
                               f"(bar {OUT_ATOL})")
    return got


def _barrier(device: torch.device) -> Callable[[Any], None]:
    if device.type == "cuda":
        return lambda _out: torch.cuda.synchronize()
    return lambda _out: None


def _peak_mib(fn: Callable[[], Any], device: torch.device
              ) -> Optional[float]:
    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 20


def run(n: int, reps: int, device: torch.device | str,
        model: Optional[STInterp] = None) -> Dict[str, Any]:
    """Check and time the three arms at `n` points (module docstring); the
    summary dict. `model` replaces the seeded bench model (the tests carry
    the JAX package's parameters in)."""
    device = require_device(str(device))
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = bench_model(device) if model is None else model
    coords, t = dense_inputs(n, device)
    barrier = _barrier(device)
    summary: Dict[str, Any] = {"n": n, "reps": reps,
                               "device": device_record(device)}
    with torch.no_grad():
        summary["checks"] = check_arms(model, coords, t, device)
        fns = {arm: (lambda arm=arm: arm_forward(model, arm, coords, t))
               for arm in ARMS}
        start = _launches()
        for arm, fn in fns.items():
            barrier(fn())
            barrier(fn())
            print(f"  warmed {arm}", flush=True)
        arms: Dict[str, Dict[str, Any]] = {}
        order = list(fns.items())
        for trial in range(TRIALS):
            for arm, fn in (order if trial % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                out = None
                for _ in range(reps):
                    out = fn()
                barrier(out)
                amort = (time.perf_counter() - t0) / reps * 1e3
                lat0 = time.perf_counter()
                barrier(fn())
                lat = (time.perf_counter() - lat0) * 1e3
                cur = arms.get(arm)
                if cur is None or amort < cur["amortized_ms"]:
                    arms[arm] = {"amortized_ms": amort, "latency_ms": lat,
                                 "mpts_per_s": n / amort / 1e3}
        end = _launches()
        for arm, fn in fns.items():
            arms[arm]["peak_memory_mib"] = _peak_mib(fn, device)
    summary["arms"] = arms
    summary["launches"] = {nm: end[nm] - start[nm] for nm in end}
    for arm in ARMS[1:]:
        summary[f"{arm}_over_plain"] = (arms[arm]["amortized_ms"]
                                        / arms["plain"]["amortized_ms"])
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=str(REPO / "results" / "bench_torch"
                                         / "dense_inference.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        device = require_device(args.device)
    except RuntimeError as e:
        print(f"bench_dense_inference: {e}", file=sys.stderr)
        return 2
    dev = device_record(device)
    print(f"[dense-inference] {dev.get('card') or dev['kind']} n={args.n} "
          f"reps={args.reps}", flush=True)
    summary = run(args.n, args.reps, device)
    c = summary["checks"]
    print("  checks against plain: first layer " + ", ".join(
        f"{a} {d:.3e}" for a, d in c["h1_max_abs"].items())
        + f" (bar {H1_ATOL}); quantiles " + ", ".join(
        f"{a} {d:.3e}" for a, d in c["out_max_abs"].items())
        + f" (bar {OUT_ATOL})", flush=True)
    for arm, s in summary["arms"].items():
        peak = s["peak_memory_mib"]
        print(f"  {arm:10s}: amortized {s['amortized_ms']:.4f} ms "
              f"({s['mpts_per_s']:.2f} M pts/s)   single-call latency "
              f"{s['latency_ms']:.4f} ms   peak "
              + ("not measured" if peak is None else f"{peak:.1f} MiB"),
              flush=True)
    for arm in ARMS[1:]:
        print(f"  {arm}/plain amortized ratio: "
              f"{summary[f'{arm}_over_plain']:.4f}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=2))
    print(f"[OK] wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
