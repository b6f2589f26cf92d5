#!/usr/bin/env python
"""How often torch's CPU vector math (MKL VML) returns a reduced-accuracy
chunk, and which MKL kernel computed it.

    python scripts/port_vml_probe.py --processes 180 --workers 4 \
        --out build/vml_probe.json

Each variant runs `--processes` fresh Python processes, `--workers` at a
time (the fault shows on a loaded host), and each process makes torch calls
on 39,000 floats, on all its OpenMP threads, against an exact reference:

  f32_sqrt   the first float32 `torch.sqrt` of the process, then a second;
  f64_sqrt   the first float64 `torch.sqrt` (and its rounding to float32);
  f32_exp    the first float32 `torch.exp`;
  warm_sqrt  a float32 `torch.sqrt` of 64 elements (one thread), then the
             39,000-element call.

A call is wrong where an element is off by more than the function's
VML_HA bound. For every wrong float32 root, the wrong elements' chunk is
recomputed by MKL's own `vmsSqrt` (the symbol torch's library exports) in
each accuracy mode (VML_LA / HA / EP) under each code path
(MKL_ENABLE_INSTRUCTIONS unset, AVX2, SSE4_2) in a child process, and the
number of elements that differ from the wrong chunk is reported: 0 names
the kernel that ran. Each process also reports the main thread's global
VML mode (`vmlGetMode`) after its calls. The JSON summary goes to --out.
CPU only; imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

N_ELEMENTS = 39_000
# relative error above which an element is wrong: VML_HA is within 1 ulp
TOL = {"f32": 2e-7, "f64": 3e-16, "exp": 2.5e-7}

_CHILD = r"""
import json, sys
import numpy as np, torch
variant, dump = sys.argv[1], sys.argv[2]
x = np.random.default_rng(7).uniform(1e-6, 2.0, {n}).astype(np.float32)
tol = {tol}
res = {{}}

def chk(tag, y, ref, t):
    rel = np.abs(np.asarray(y, np.float64) - ref) / np.abs(ref)
    bad = np.nonzero(rel > t)[0]
    res[tag] = [int(bad.size), int(bad.min()) if bad.size else -1,
                int(bad.max()) if bad.size else -1, float(rel.max())]
    if bad.size and tag.startswith("f32_sqrt"):
        np.savez(dump, x=x, y=y, bad=bad)

if variant == "f32_sqrt":
    for i in range(2):
        chk(f"f32_sqrt_call{{i}}", torch.sqrt(torch.as_tensor(x)).numpy(),
            np.sqrt(x).astype(np.float64), tol["f32"])
elif variant == "f64_sqrt":
    y = torch.sqrt(torch.as_tensor(x.astype(np.float64))).numpy()
    chk("f64_sqrt", y, np.sqrt(x.astype(np.float64)), tol["f64"])
    chk("f64_sqrt_rounded", y.astype(np.float32),
        np.sqrt(x).astype(np.float64), 1e-9)
elif variant == "f32_exp":
    xe = -10 * x
    chk("f32_exp", torch.exp(torch.as_tensor(xe)).numpy(),
        np.exp(xe.astype(np.float64)), tol["exp"])
elif variant == "warm_sqrt":
    torch.sqrt(torch.as_tensor(x[:64]))
    chk("f32_sqrt_after_warm", torch.sqrt(torch.as_tensor(x)).numpy(),
        np.sqrt(x).astype(np.float64), tol["f32"])
import ctypes, os
lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                               "libtorch_cpu.so"))
lib.VMLGETMODE_.restype = ctypes.c_int64
res["threads"] = torch.get_num_threads()
res["vml_mode"] = hex(lib.VMLGETMODE_())   # the calling thread's mode
print(json.dumps(res))
"""

_KERNEL = r"""
import ctypes, json, os, sys
import numpy as np, torch
lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                               "libtorch_cpu.so"))
f = lib.VMSSQRT_
f.restype = None
d = np.load(sys.argv[1])
lo, hi = int(d["bad"].min()), int(d["bad"].max()) + 1
xs = np.ascontiguousarray(d["x"][lo:hi])
res = {}
for name, mode in (("LA", 1), ("HA", 2), ("EP", 3)):
    out = np.empty_like(xs)
    n = ctypes.c_int64(xs.size)
    m = ctypes.c_int64(mode | 0x140000 | 0x100)   # FTZDAZ_OFF, ERRMODE_IGNORE
    f(ctypes.byref(n), xs.ctypes.data_as(ctypes.c_void_p),
      out.ctypes.data_as(ctypes.c_void_p), ctypes.byref(m))
    res[name] = int((out != d["y"][lo:hi]).sum())
print(json.dumps({"chunk": [lo, hi], "differing": res}))
"""

VARIANTS = ("f32_sqrt", "f64_sqrt", "f32_exp", "warm_sqrt")
PATHS = ("default", "AVX2", "SSE4_2")


def run_child(variant: str, dump: Path) -> dict:
    src = _CHILD.format(n=N_ELEMENTS, tol=repr(TOL))
    out = subprocess.run([sys.executable, "-c", src, variant, str(dump)],
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def identify(dump: Path) -> dict:
    """Elements of the wrong chunk that each MKL kernel computes otherwise."""
    found = {}
    for path in PATHS:
        env = dict(os.environ)
        env.pop("MKL_ENABLE_INSTRUCTIONS", None)
        if path != "default":
            env["MKL_ENABLE_INSTRUCTIONS"] = path
        out = subprocess.run([sys.executable, "-c", _KERNEL, str(dump)],
                             capture_output=True, text=True, env=env,
                             check=True)
        found[path] = json.loads(out.stdout.strip().splitlines()[-1])
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=180,
                    help="fresh processes a variant")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    summary = {"processes": args.processes, "elements": N_ELEMENTS,
               "load_average_at_start": os.getloadavg(), "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(v, i) for i in range(args.processes) for v in args.variants]
        with ThreadPoolExecutor(args.workers) as pool:
            results = list(pool.map(
                lambda job: (job, run_child(job[0], Path(tmp) / (
                    f"{job[0]}_{job[1]}.npz"))), jobs))
        for (variant, i), res in results:
            threads, mode = res.pop("threads"), res.pop("vml_mode")
            entry = summary["variants"].setdefault(
                variant, {"threads": threads, "calls": {}, "wrong": [],
                          "vml_modes": []})
            if mode not in entry["vml_modes"]:
                entry["vml_modes"].append(mode)
            for tag, (n_bad, lo, hi, rel) in res.items():
                calls = entry["calls"].setdefault(tag, [0, 0])
                calls[1] += 1
                if n_bad:
                    calls[0] += 1
                    wrong = {"process": i, "call": tag, "elements": n_bad,
                             "first": lo, "last": hi, "max_rel": rel}
                    dump = Path(tmp) / f"{variant}_{i}.npz"
                    if tag.startswith("f32_sqrt") and dump.exists():
                        wrong["kernels"] = identify(dump)
                    entry["wrong"].append(wrong)
    summary["load_average_at_end"] = os.getloadavg()
    for variant, entry in summary["variants"].items():
        print(f"{variant} ({entry['threads']} threads, VML mode after the "
              f"calls {', '.join(entry['vml_modes'])}): " + ", ".join(
            f"{tag} wrong in {w} of {n} processes"
            for tag, (w, n) in entry["calls"].items()))
        for wrong in entry["wrong"]:
            line = (f"  process {wrong['process']} {wrong['call']}: "
                    f"{wrong['elements']} elements in [{wrong['first']}, "
                    f"{wrong['last']}], max rel {wrong['max_rel']:.3g}")
            if "kernels" in wrong:
                line += "; elements differing from MKL's vmsSqrt " + "; ".join(
                    f"{path} {k['differing']}"
                    for path, k in wrong["kernels"].items())
            print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
