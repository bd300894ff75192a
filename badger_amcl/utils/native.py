"""ctypes bindings to the native C++ host-runtime library (native/).

The reference's host-side runtime is C++ (the whole node is); ours keeps the
one-shot heavy host tasks native too: exact EDT for big maps and binary
octree (.bt) decoding. Python/numpy fallbacks are used automatically when the
shared library has not been built, so nothing here is load-bearing for
correctness — only for startup latency on large maps.

Build: `make -C native` (produces native/libamcl_host.so).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libamcl_host.so",
    )
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.amcl_edt_2d.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.amcl_edt_3d.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def edt_cells(occupied: np.ndarray) -> Optional[np.ndarray]:
    """Exact EDT in cell units via the native library; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    occ = np.ascontiguousarray(occupied.astype(np.uint8))
    out = np.empty(occ.shape, dtype=np.float64)
    if occ.ndim == 2:
        h, w = occ.shape
        lib.amcl_edt_2d(
            occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h,
            w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    elif occ.ndim == 3:
        a, b, c = occ.shape
        lib.amcl_edt_3d(
            occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            a,
            b,
            c,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    else:
        return None
    return out

