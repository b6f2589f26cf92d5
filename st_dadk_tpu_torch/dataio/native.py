"""ctypes binding of the native C++ CSV ingest (port of
`st_dadk_tpu/dataio/native.py`, on `native/ingest.cpp`).

The native loader parses, site-indexes and densifies a KAUST CSV in one
C++ pass with the numpy reader's semantics (first-appearance site order
over the exact float64 (x, y), 1-based t, NaN holes, a leading id column
and quoted headers tolerated). Its library is built with g++ at the first
call (`ops/_build.py::load_host_library`); unlike the JAX package, which
falls back to pandas without a word, a build that fails raises, and so
does a file the loader refuses, with the loader's reason.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from st_dadk_tpu_torch.ops import _build

_LIB: Optional[ctypes.CDLL] = None
# stdadk_load_csv's nonzero return codes (native/ingest.cpp)
_REFUSALS = {2: "the file could not be read whole",
             3: "it has no header line",
             4: "its header has no x or no y column",
             5: "the dense (T, S) matrix could not be allocated"}


def _get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load_host_library("ingest")
        lib.stdadk_load_csv.restype = ctypes.c_int
        lib.stdadk_load_csv.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.stdadk_free.restype = None
        lib.stdadk_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def load_csv_native(path: str | Path
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(z (T, S) float32, coords (S, 2) float64, rows). A file that cannot
    be opened raises FileNotFoundError; one the loader refuses otherwise
    raises ValueError with the loader's reason.

    Coords come back as the exact parsed doubles, so the site index matches
    the numpy reader's float64 one; callers downcast for the model."""
    lib = _get_lib()
    z_ptr = ctypes.POINTER(ctypes.c_float)()
    c_ptr = ctypes.POINTER(ctypes.c_double)()
    T = ctypes.c_int64()
    S = ctypes.c_int64()
    rows = ctypes.c_int64()
    rc = lib.stdadk_load_csv(str(path).encode(), ctypes.byref(z_ptr),
                             ctypes.byref(c_ptr), ctypes.byref(T),
                             ctypes.byref(S), ctypes.byref(rows))
    if rc == 1:
        raise FileNotFoundError(f"cannot open {path}")
    if rc != 0:
        raise ValueError(f"cannot load {path}: "
                         + _REFUSALS.get(rc, f"loader code {rc}"))
    try:
        t, s = T.value, S.value
        z = np.ctypeslib.as_array(z_ptr, shape=(t, s)).copy()
        coords = np.ctypeslib.as_array(c_ptr, shape=(s, 2)).copy()
    finally:
        lib.stdadk_free(z_ptr)
        lib.stdadk_free(c_ptr)
    return z, coords, rows.value
