"""Build the package's CUDA sources with nvcc at first use; load with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/cuda/lib<name>-<hash>.so` at the root of the checkout (a
directory `.gitignore` lists). The hash covers the source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source or header builds
anew and an unchanged one loads from disk. Nothing
here runs at import: `load_library` is called by a kernel wrapper the first
time it launches on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []) \
            + ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, every shared header
    in csrc/ and the flags, so a header edit builds anew too."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile csrc/<name>.cu unless the library for its hash exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def load_library(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib
