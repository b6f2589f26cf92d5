"""Device time a launch of four of the port's kernels, beside other builds of
their sources, on one GPU.

    python3 -m st_dadk_tpu_torch.time_kernels [--previous DIR] [--variants]
                                               [--tiles] [--out FILE]

  --previous DIR  a copy of an earlier `st_dadk_tpu_torch/csrc/` (its `.cu`
                  files and headers), e.g. written with `git show
                  <commit>:st_dadk_tpu_torch/csrc/<file>` into a directory
                  that .gitignore lists. Its entry points have that
                  commit's C signatures (PREVIOUS_SIGNATURES: the basis
                  forward and d centers without a mask and a lane count).
  --variants      also build the current sources with one part replaced by
                  text (VARIANTS): what a kernel costs without its phi, with
                  one TF32 product instead of three, and so on.
  --tiles         also time the current kernels at every tile of their
                  planners (`fused_first_layer.FWD_TILES`, `BP_TILES`,
                  `spatial_basis_kernels.BASIS_FWD_TILES_P`,
                  `BASIS_BP_TILES_P`), not only the planner's choice.

The kernels: the fused forward (FWD), the fused d coords (BP), the basis
forward (BFWD), the basis d coords (BPT) and the basis d centers (BC).
Every version is built with the package's nvcc flags into
`build/time_kernels/<version>/`, all builds at once, loaded with ctypes
and called directly on preallocated outputs. At
each fit shape it times every version of a kernel by CUDA-graph replay
(`utils/timing.graph_ms`: device time a launch), in the order previous,
current, variants..., current, previous, and reports the two current and
the two previous runs' means. Prints one line a (kernel, shape, version)
and writes `--out` (JSON).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from st_dadk_tpu_torch.ops import _build
from st_dadk_tpu_torch.ops import fused_first_layer as ffl
from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
from st_dadk_tpu_torch.ops.basis import BASIS_IDS
from st_dadk_tpu_torch.utils.timing import graph_ms

REPO = Path(__file__).resolve().parents[1]
OUT_DIR = REPO / "build" / "time_kernels"
SHAPES = [(512, 227, 256), (2000, 227, 256), (32768, 227, 256)]
FWD, BP = "st_fused_first_layer_fwd", "st_fused_first_layer_bwd_points"
BFWD, BC = "st_spatial_basis_fwd", "st_spatial_basis_bwd_centers"
BPT = "st_spatial_basis_bwd_points"
LIBS = {FWD: "fused_first_layer", BP: "fused_first_layer",
        BFWD: "spatial_basis", BPT: "spatial_basis", BC: "spatial_basis"}
_P, _I = ctypes.c_void_p, ctypes.c_int
# (pointer, int) argument counts before the stream
CURRENT_SIGNATURES = {FWD: (5, 7), BP: (7, 7), BFWD: (5, 7), BPT: (5, 5),
                      BC: (8, 5)}
PREVIOUS_SIGNATURES = {FWD: (5, 7), BP: (7, 7), BFWD: (4, 6), BPT: (5, 5),
                       BC: (7, 4)}
# name -> (entry point, source file, text, replacement): one part of the
# current source replaced, to see what it costs
VARIANTS = {
    "fwd_cheap_phi": (
        FWD, "fused_first_layer.cu",
        "      const float v = basis_phi(__fmul_rn(guarded_dist(d2), ib), "
        "basis);",
        "      const float v = __fmul_rn(d2, ib);"),
    "fwd_one_tf32": (
        FWD, "fused_first_layer.cu",
        "          mma_3xtf32(acc[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);",
        "          mma_tf32(acc[mt][nt], a_hi[mt], b_hi);"),
    "bp_one_tf32": (
        BP, "fused_first_layer.cu",
        "          mma_3xtf32(gw[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);",
        "          mma_tf32(gw[mt][nt], a_hi[mt], b_hi);"),
    "bp_no_mma": (
        BP, "fused_first_layer.cu",
        "          mma_3xtf32(gw[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);",
        "          gw[mt][nt][0] += __uint_as_float(a_hi[mt][0] ^ b_lo[1]);"),
    "bp_cheap_chain": (
        BP, "fused_first_layer.cu",
        "              gw[mt][nt][2 * half + u] * basis_dphi(__fmul_rn(d, ib), "
        "basis);",
        "              gw[mt][nt][2 * half + u] * d;"),
    "bfwd_cheap_phi": (
        BFWD, "spatial_basis.cu",
        "      v[u] = basis_phi(__fmul_rn(guarded_dist(d2), ib[u]), basis);",
        "      v[u] = __fmul_rn(d2, ib[u]);"),
    "bfwd_no_store": (
        BFWD, "spatial_basis.cu",
        "      *row = v[0];",
        "      if (v[0] == 1234.5f) *row = v[0];"),
    "bpt_no_chain": (
        BPT, "spatial_basis.cu",
        "        points_term<BASIS>(px, py, cx[m], cy[m], ib[m], gv, tx, ty);",
        "        tx = gv * cx[m];\n        ty = gv * cy[m];"),
    "bpt_ieee_sqrt": (
        BPT, "spatial_basis.cu",
        "  sqrt_and_rsqrt(d2g, d, inv_d);",
        "  d = guarded_dist(d2);\n  inv_d = rsqrtf(d2g);"),
    "bpt_branchy_dphi": (
        BPT, "spatial_basis.cu",
        "  const float gphi = g * points_dphi<BASIS>(__fmul_rn(d, ib));",
        "  const float gphi = g * basis_dphi(__fmul_rn(d, ib), BASIS);"),
    "bpt_no_inv_d": (
        BPT, "spatial_basis.cu",
        "  const float coef = d2 >= 1e-24f ? gphi * ib * inv_d : 0.0f;",
        "  const float coef = d2 >= 1e-24f ? gphi * ib : 0.0f;"),
    "bpt_ieee_div": (
        BPT, "spatial_basis.cu",
        "  const float coef = d2 >= 1e-24f ? gphi * ib * inv_d : 0.0f;",
        "  const float coef = spatial_coef(gphi, ib, d2, d);"),
    "bpt_no_g_loads": (
        BPT, "spatial_basis.cu",
        "      cp_async16(gs + v, src + v, true);",
        "      ;"),
    "bc_no_dphi": (
        BC, "spatial_basis.cu",
        "          g[(size_t)p * k + c] * basis_dphi(__fmul_rn(d, ib), "
        "basis);",
        "          g[(size_t)p * k + c];"),
}


def _build_dir(src: Path, dst: Path, name: str) -> Path:
    """Compile dst/<name>.cu (headers beside it) into dst/lib<name>.so."""
    out = dst / f"lib{name}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
           str(dst / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}/{name}.cu:\n{proc.stderr}")
    return out


def _copy(src: Path, dst: Path, edit=None) -> None:
    """Copy the .cu and .cuh files of src into dst, applying `edit`
    (file, text, replacement), whose text must occur exactly once."""
    if dst.exists():
        shutil.rmtree(dst)
    dst.mkdir(parents=True)
    for f in sorted(src.glob("*.cu*")):
        text = f.read_text()
        if edit and f.name == edit[0]:
            if text.count(edit[1]) != 1:
                raise RuntimeError(f"variant text not found once in {f}: "
                                   f"{edit[1]!r}")
            text = text.replace(edit[1], edit[2])
        (dst / f.name).write_text(text)


def _load(path: Path, entry: str, sig) -> ctypes.CDLL:
    fn = getattr(ctypes.CDLL(str(path)), entry)
    fn.argtypes = [_P] * sig[0] + [_I] * sig[1] + [_P]
    fn.restype = ctypes.c_int
    return fn


def build_versions(previous, variants):
    """{version: {entry point: (ctypes function, current signature?)}}."""
    jobs = {}   # (version, lib) -> (source dir, edit)
    for lib in set(LIBS.values()):
        jobs[("current", lib)] = (_build.CSRC, None)
        if previous is not None:
            jobs[("previous", lib)] = (previous, None)
    for vname, (entry, fname, text, repl) in (VARIANTS.items() if variants
                                              else ()):
        jobs[(vname, LIBS[entry])] = (_build.CSRC, (fname, text, repl))
    for version, (src, edit) in {v: job for (v, _), job in
                                 jobs.items()}.items():
        _copy(src, OUT_DIR / version, edit)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {key: pool.submit(_build_dir, src, OUT_DIR / key[0], key[1])
                for key, (src, _) in jobs.items()}
        paths = {key: f.result() for key, f in futs.items()}
    versions = {}
    for (version, lib), path in paths.items():
        cur = version != "previous"
        for entry in (e for e, nm in LIBS.items() if nm == lib):
            if version in VARIANTS and VARIANTS[version][0] != entry:
                continue
            sig = (CURRENT_SIGNATURES if cur else PREVIOUS_SIGNATURES)[entry]
            versions.setdefault(version, {})[entry] = (
                _load(path, entry, sig), cur)
    return versions


def _inputs(n, k, h, seed=99):
    g = torch.Generator().manual_seed(seed)
    coords = torch.rand((n, 2), generator=g)
    centers = torch.rand((k, 2), generator=g)
    inv_bw = 1.0 / (0.1 + 0.7 * torch.rand((k,), generator=g))
    w = 0.1 * torch.randn((k, h), generator=g)
    grad_h = torch.randn((n, h), generator=g) / n
    grad_phi = torch.randn((n, k), generator=g) / n
    return [t.cuda() for t in (coords, centers, inv_bw, w, grad_h, grad_phi)]


def _call(entry, fn, current, args, n, k, h, tile=None):
    """A closure launching `fn` on outputs allocated here, which it keeps
    alive; returns the C entry point's error code. `tile` overrides the
    current kernel's planned tile."""
    coords, centers, inv_bw, w, grad_h, grad_phi = args
    bid = BASIS_IDS["wendland"]

    def empty(*shape):
        return torch.empty(shape, device="cuda")

    if entry == FWD:
        bufs = (coords, centers, inv_bw, w, empty(n, h))
        ints = (n, k, h, bid) + (tile or ffl.fwd_tile(n, k, h)) + (1,)
    elif entry == BP:
        bp, ct = tile or ffl.bwd_points_tile(n, k, h)
        slabs = -(-k // ct)
        bufs = (coords, centers, inv_bw, w, grad_h, empty(n, 2),
                empty(slabs if slabs > 1 else 0, n, 2))
        ints = (n, k, h, bid, bp, ct, slabs)
    elif entry == BFWD:
        # the current entry point: no mask, one lane
        bufs = (coords, centers, inv_bw) + ((None,) if current else ()) + (
            empty(n, k),)
        plan = sbk.basis_fwd_plan(n, k)
        ints = (n, k, bid) + (((tile,) + plan[1:]) if tile else plan) + (
            (1,) if current else ())
    elif entry == BPT:
        bufs = (coords, centers, inv_bw, grad_phi, empty(n, 2))
        ints = (n, k, bid) + (tile or sbk.basis_bwd_points_plan(n, k))
    else:
        ws = sbk.basis_bwd_centers_workspace(n, k, "cuda")
        bufs = (coords, centers, inv_bw) + ((None,) if current else ()) + (
            grad_phi, empty(k, 2), empty(k), ws)
        ints = (n, k, bid, ws.shape[0]) + ((1,) if current else ())
    ptrs = [None if t is None else t.data_ptr() for t in bufs]

    def call():
        return fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    call.bufs = bufs
    return call


def _tiles(entry):
    """{version name: tile} of the current kernel at every planner tile."""
    if entry == FWD:
        return {f"current@{bn}x{bh}": (bn, bh) for bn, bh in ffl.FWD_TILES}
    if entry == BP:
        return {f"current@{bp}x{ct}": (bp, ct) for bp, ct in ffl.BP_TILES}
    if entry == BFWD:
        return {f"current@p{tp}": tp for tp in sbk.BASIS_FWD_TILES_P}
    if entry == BPT:
        return {f"current@p{tp}": (tp, 32 * min(8, tp))
                for tp in sbk.BASIS_BP_TILES_P}
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--previous", type=Path, default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=REPO / "build" / "time_kernels.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    versions = build_versions(args.previous, args.variants)
    order = (["previous"] if "previous" in versions else []) + ["current"]
    order += [v for v in versions if v not in ("previous", "current")]
    result = {"card": card, "ms": {}}
    for n, k, h in SHAPES:
        data = _inputs(n, k, h)
        for entry in (FWD, BP, BFWD, BPT, BC):
            names = [v for v in order if entry in versions[v]]
            runs = {}
            tiles = _tiles(entry) if args.tiles else {}
            for v in names + list(tiles) + names[:2][::-1]:
                fn, cur = versions[v.split("@")[0]][entry]
                call = _call(entry, fn, cur, data, n, k, h, tiles.get(v))
                rc = call()
                if rc != 0:
                    raise RuntimeError(f"{v} {entry}: CUDA error {rc}")
                runs.setdefault(v, []).append(graph_ms(call))
            for v, ms in runs.items():
                mean = sum(ms) / len(ms)
                result["ms"].setdefault(entry, {}).setdefault(
                    str(n), {})[v] = mean
                print(f"{entry:32s} N={n:6d} k={k} H={h} {v:17s} "
                      f"{mean:.5f} ms device a launch "
                      f"({', '.join(f'{x:.5f}' for x in ms)})", flush=True)
        del data
        torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
