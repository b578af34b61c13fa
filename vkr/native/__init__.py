"""ctypes bindings for the native asset-pipeline runtime.

Loads build/libvkr_native.so when present (make -C vkr/native);
callers fall back to the numpy implementations when it isn't. The native
and numpy paths are bit-identical (tests/test_native.py).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "build",
                         "libvkr_native.so")
_lib: Optional[ctypes.CDLL] = None


def load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.vkr_native_abi_version.restype = ctypes.c_int32
    if lib.vkr_native_abi_version() != 1:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    lib.mip_downsample_rgba8.argtypes = [u8p, u8p, i64, i64]
    lib.resize_rgba8.argtypes = [u8p, i64, i64, u8p, i64, i64]
    lib.expand_triangles.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), i64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.transform_points.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        i64, ctypes.POINTER(ctypes.c_float),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def mip_downsample_rgba8(src: np.ndarray) -> np.ndarray:
    """(n, s, s, 4) u8 -> (n, s/2, s/2, 4) u8 box filter."""
    lib = load()
    n, s = src.shape[0], src.shape[1]
    src = np.ascontiguousarray(src)
    dst = np.empty((n, s // 2, s // 2, 4), np.uint8)
    lib.mip_downsample_rgba8(_u8p(src), _u8p(dst), n, s)
    return dst


def resize_rgba8(src: np.ndarray, h2: int, w2: int) -> np.ndarray:
    lib = load()
    src = np.ascontiguousarray(src)
    h, w = src.shape[:2]
    dst = np.empty((h2, w2, 4), np.uint8)
    lib.resize_rgba8(_u8p(src), h, w, _u8p(dst), h2, w2)
    return dst


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    lib = load()
    m = np.ascontiguousarray(m, np.float32)
    pts = np.ascontiguousarray(pts, np.float32)
    dst = np.empty_like(pts)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.transform_points(
        m.ctypes.data_as(f32p), pts.ctypes.data_as(f32p), len(pts),
        dst.ctypes.data_as(f32p),
    )
    return dst
