"""Host-side speckle filter and occlusion fill: the reference's C++, in
the port's own copy.

Compiles ``csrc/speckle.cpp`` (the text of the reference's
``native/src/speckle.cpp``) with ``g++`` into ``build/kernels/`` (see
``ops/cuda/build.py``) and calls it through ctypes. A failed build raises;
there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from .ops.cuda.build import CSRC_DIR, compile_library

SPECKLE_SOURCE = CSRC_DIR / "speckle.cpp"
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
            lib.stpu_fill_invalid_lr.restype = None
            lib.stpu_fill_invalid_lr.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64, ctypes.c_int64,
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


def fill_invalid_lr(disp: np.ndarray, valid: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Fill each invalid pixel with the smaller of the nearest valid
    disparities to its left and right on the same row (occlusions belong
    to the background).

    Returns (disp_filled, filled_mask); inputs are not modified. A pixel is
    fillable iff its row has at least one valid pixel.
    """
    disp = np.ascontiguousarray(disp, dtype=np.float32).copy()
    valid = np.ascontiguousarray(valid, dtype=bool)
    h, w = disp.shape
    valid_u8 = valid.astype(np.uint8)
    load().stpu_fill_invalid_lr(
        disp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        valid_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
    )
    filled = (~valid) & valid.any(axis=1, keepdims=True)
    return disp, filled
