"""Device time a launch of the fused forward and the basis d-centers kernels,
beside other builds of their sources, on one GPU.

    python3 -m st_dadk_tpu_torch.time_kernels [--previous DIR] [--variants]
                                               [--fwd-tiles] [--out FILE]

  --previous DIR  a copy of an earlier `st_dadk_tpu_torch/csrc/` (its `.cu`
                  files and headers), e.g. written with `git show
                  <commit>:st_dadk_tpu_torch/csrc/<file>` into a directory
                  that .gitignore lists. Its two entry points have the
                  earlier C signatures: the forward without a tile, d
                  centers without a workspace (PREVIOUS_SIGNATURES).
  --variants      also build the current sources with one part replaced by
                  text (VARIANTS): what a kernel costs without its phi, with
                  one TF32 product instead of three, and so on.
  --fwd-tiles     also time the current forward at every tile of
                  `fused_first_layer.FWD_TILES`, not only `fwd_tile`'s.

Every version is built with the package's nvcc flags into
`build/time_kernels/<version>/`, all builds at once, loaded with ctypes and
called directly on preallocated outputs. At each fit shape it times every
version of a kernel by CUDA-graph replay (`utils/timing.graph_ms`: device
time a launch), in the order previous, current, variants..., current,
previous, and reports the two current and the two previous runs' means.
Prints one line a (kernel, shape, version) and writes `--out` (JSON).
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
FWD, BC = "st_fused_first_layer_fwd", "st_spatial_basis_bwd_centers"
LIBS = {FWD: "fused_first_layer", BC: "spatial_basis"}
_P, _I = ctypes.c_void_p, ctypes.c_int
# (pointer, int) argument counts before the stream
CURRENT_SIGNATURES = {FWD: (5, 6), BC: (7, 4)}
PREVIOUS_SIGNATURES = {FWD: (5, 4), BC: (6, 3)}
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
    "fwd_no_store": (
        FWD, "fused_first_layer.cu",
        "          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);",
        "          if (v0 == 1234.5f) *dst = v1;"),
    "fwd_phi_div_three": (
        FWD, "basis_device.cuh",
        "(35.0f * rc * rc + 18.0f * rc + 3.0f) *\n           (1.0f / 3.0f);",
        "(35.0f * rc * rc + 18.0f * rc + 3.0f) / 3.0f;"),
    "fwd_rna_split": (
        FWD, "fused_first_layer.cu",
        "  hi = __float_as_uint(x) & 0xffffe000u;\n"
        "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));",
        "  split_tf32(x, hi, lo);"),
    "fwd_16x64_kc16": (
        FWD, "fused_first_layer.cu",
        "launch_fwd<16, 64, 1, 64>(", "launch_fwd<16, 64, 1, 16>("),
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
    for lib in LIBS.values():
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
        entry = next(e for e, nm in LIBS.items() if nm == lib)
        cur = version != "previous"
        sig = (CURRENT_SIGNATURES if cur else PREVIOUS_SIGNATURES)[entry]
        versions.setdefault(version, {})[entry] = (_load(path, entry, sig),
                                                   cur)
    return versions


def _inputs(n, k, h, seed=99):
    g = torch.Generator().manual_seed(seed)
    coords = torch.rand((n, 2), generator=g)
    centers = torch.rand((k, 2), generator=g)
    inv_bw = 1.0 / (0.1 + 0.7 * torch.rand((k,), generator=g))
    w = 0.1 * torch.randn((k, h), generator=g)
    grad_phi = torch.randn((n, k), generator=g) / n
    return [t.cuda() for t in (coords, centers, inv_bw, w, grad_phi)]


def _call(entry, fn, current, args, n, k, h, tile=None):
    """A closure launching `fn` on outputs allocated here, which it keeps
    alive; returns the C entry point's error code. `tile` overrides the
    current forward's tile."""
    coords, centers, inv_bw, w, g = args
    bid = BASIS_IDS["wendland"]
    if entry == FWD:
        bufs = (coords, centers, inv_bw, w, torch.empty((n, h), device="cuda"))
        ints = (n, k, h, bid) + (tile or ffl.fwd_tile(n, k, h) if current
                                 else ())
    else:
        bufs = (coords, centers, inv_bw, g, torch.empty((k, 2), device="cuda"),
                torch.empty((k,), device="cuda"))
        ints = (n, k, bid)
        if current:
            ws = sbk.basis_bwd_centers_workspace(n, k, "cuda")
            bufs += (ws,)
            ints += (ws.shape[0],)
    ptrs = [t.data_ptr() for t in bufs]

    def call():
        return fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    call.bufs = bufs
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--previous", type=Path, default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--fwd-tiles", action="store_true")
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
        for entry in (FWD, BC):
            names = [v for v in order if entry in versions[v]]
            runs = {}
            tiles = {}
            if entry == FWD and args.fwd_tiles:
                tiles = {f"current@{bn}x{bh}": (bn, bh)
                         for bn, bh in ffl.FWD_TILES}
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
                print(f"{entry:30s} N={n:6d} k={k} H={h} {v:15s} "
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
