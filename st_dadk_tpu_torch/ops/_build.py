"""Build the package's native sources at first use; load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
with nvcc into `build/cuda/lib<name>-<hash>.so` at the root of the checkout
(a directory `.gitignore` lists). The hash covers the source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source or header builds
anew and an unchanged one loads from disk.

The host libraries are the repo's C++ in `native/<name>.cpp` (the exact
transport solver and the CSV ingest), compiled with g++ and the flags of
`native/Makefile` into `build/host/lib<name>-<hash>.so` (the hash covers
the source and the flags). The libraries committed in `native/` are never
loaded: a failed build raises.

Nothing here runs at import: `load_library` / `load_host_library` are
called by a wrapper the first time it needs its library.
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
NATIVE = Path(__file__).resolve().parents[2] / "native"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
# native/Makefile's flags (x86-64-v2, not -march=native: one build serves
# every host the checkout runs on)
HOST_FLAGS = ("-O3", "-march=x86-64-v2", "-fPIC", "-std=c++17", "-shared")
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


def _compile(out: Path, cmd_head: list, src: Path, verbose: bool) -> Path:
    """Run `cmd_head -o <tmp> src` and move the library to `out` unless it
    exists; RuntimeError with the compiler's output on a failure."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run([*cmd_head, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{Path(cmd_head[0]).name} failed for {src.name}:"
                           f"\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


def build(name: str, verbose: bool = False) -> Path:
    """Compile csrc/<name>.cu unless the library for its hash exists."""
    return _compile(library_path(name), [nvcc_path(), *NVCC_FLAGS],
                    CSRC / f"{name}.cu", verbose)


def load_library(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib


def gxx_path() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host libraries of native/ "
                           "build with g++")
    return path


def host_library_path(name: str) -> Path:
    """The host library's path; its hash covers native/<name>.cpp and the
    flags."""
    h = hashlib.sha256((NATIVE / f"{name}.cpp").read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return HOST_BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_host(name: str, verbose: bool = False) -> Path:
    """Compile native/<name>.cpp with g++ unless the library for its hash
    exists."""
    return _compile(host_library_path(name), [gxx_path(), *HOST_FLAGS],
                    NATIVE / f"{name}.cpp", verbose)


def load_host_library(name: str) -> ctypes.CDLL:
    """The host library of native/<name>.cpp, built at the first call."""
    key = f"host/{name}"
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(name)))
            _LIBS[key] = lib
        return lib
