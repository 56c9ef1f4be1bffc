"""Host-side speckle filter: the reference's C++, built for the port.

Compiles ``stereo_tpu/native/src/speckle.cpp`` by path with ``g++`` into
``build/kernels/`` (see ``ops/cuda/build.py``) and calls it through
ctypes. Importing ``stereo_tpu.native`` would load jax, so the source is
read, not imported. A failed build raises; there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from .ops.cuda.build import PACKAGE_DIR, compile_library

SPECKLE_SOURCE = PACKAGE_DIR.parent / "stereo_tpu" / "native" / "src" / "speckle.cpp"
GXX_FLAGS = ["g++", "-O3", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The speckle library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(
                compile_library("stereo_speckle", [SPECKLE_SOURCE], GXX_FLAGS)
            ))
            lib.stpu_filter_speckles.restype = ctypes.c_int64
            lib.stpu_filter_speckles.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                ctypes.c_int64, ctypes.c_float, ctypes.c_int32,
            ]
            _lib = lib
        return _lib


def filter_speckles(
    disp: np.ndarray, valid: np.ndarray, tau: float, max_size: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Invalidate 4-connected components of similar disparity (neighbours
    within ``tau``) smaller than ``max_size`` pixels.

    Returns (disp, valid, n_removed); inputs are not modified.
    """
    disp = np.ascontiguousarray(disp, dtype=np.float32).copy()
    valid_u8 = np.ascontiguousarray(valid, dtype=np.uint8).copy()
    h, w = disp.shape
    removed = load().stpu_filter_speckles(
        disp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        valid_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, float(tau), int(max_size), 0.0, 0,
    )
    return disp, valid_u8.astype(bool), int(removed)
