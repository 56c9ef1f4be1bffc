"""Host-side speckle filter, occlusion fill and PNM/PFM image files: the
reference's C++, in the port's own copy.

Compiles ``csrc/speckle.cpp`` and ``csrc/pnm.cpp`` (the text of the
reference's ``native/src/``) with ``g++`` into one library in
``build/kernels/`` (see ``ops/cuda/build.py``) and calls it through
ctypes. A failed build raises; there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from .ops.cuda.build import CSRC_DIR, compile_library

SOURCES = [CSRC_DIR / "speckle.cpp", CSRC_DIR / "pnm.cpp"]
GXX_FLAGS = ["g++", "-O3", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The native library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(
                compile_library("stereo_native", SOURCES, GXX_FLAGS)))
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
            i64p = ctypes.POINTER(ctypes.c_int64)
            signatures = {
                # path, w, h, channels -> 0, or < 0 for a file it cannot read
                "stpu_pnm_probe": [ctypes.c_char_p, i64p, i64p,
                                   ctypes.POINTER(ctypes.c_int32)],
                # path, out [h * w] uint8, w, h
                "stpu_pnm_read_gray": [ctypes.c_char_p, _U8P,
                                       ctypes.c_int64, ctypes.c_int64],
                "stpu_pnm_write_gray": [ctypes.c_char_p, _U8P,
                                        ctypes.c_int64, ctypes.c_int64],
                # path, w, h
                "stpu_pfm_probe": [ctypes.c_char_p, i64p, i64p],
                # path, out [h * w] float32, w, h
                "stpu_pfm_read": [ctypes.c_char_p, _F32P, ctypes.c_int64,
                                  ctypes.c_int64],
            }
            for name, argtypes in signatures.items():
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int32
            _lib = lib
        return _lib


_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


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


def read_pnm_gray(path: str) -> Optional[np.ndarray]:
    """A binary P5 or P6 file (maxval <= 255) as [H, W] uint8 grayscale
    (P6: BT.601 integer luma, as PIL's ``convert("L")``); None for a file
    of another kind, which the caller reads otherwise."""
    lib = load()
    w, h = ctypes.c_int64(), ctypes.c_int64()
    channels = ctypes.c_int32()
    if lib.stpu_pnm_probe(path.encode(), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(channels)):
        return None
    out = np.empty((h.value, w.value), dtype=np.uint8)
    if lib.stpu_pnm_read_gray(path.encode(), out.ctypes.data_as(_U8P),
                              w.value, h.value):
        return None
    return out


def read_pfm_native(path: str) -> Optional[np.ndarray]:
    """A single-channel ("Pf") PFM file as [H, W] float32, top row first;
    None for a file of another kind."""
    lib = load()
    w, h = ctypes.c_int64(), ctypes.c_int64()
    if lib.stpu_pfm_probe(path.encode(), ctypes.byref(w), ctypes.byref(h)):
        return None
    out = np.empty((h.value, w.value), dtype=np.float32)
    if lib.stpu_pfm_read(path.encode(), out.ctypes.data_as(_F32P), w.value,
                         h.value):
        return None
    return out


def write_pnm_gray(path: str, img: np.ndarray) -> bool:
    """Write [H, W] uint8 as binary P5; True on success."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    return load().stpu_pnm_write_gray(
        path.encode(), img.ctypes.data_as(_U8P), img.shape[1],
        img.shape[0]) == 0
