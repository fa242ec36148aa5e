"""ctypes binding to the repository's native I/O helpers
(``native/librspc_native.so``), the port's own copy of
``rspc_tpu/io/native.py``: the LZF codec and the threaded dataset loader.

The library is built from ``native/*.cpp`` with ``make -C native`` the
first time it is needed (into a temporary name, then renamed, so that
concurrent first uses never load a half-written file). Every entry point
returns None when the library is missing or does not build, and the
callers then take their pure-Python versions, so the port never depends
on a compiler. These are host codecs, not device kernels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native")
)
_LIB_NAME = "librspc_native.so"
LIB_PATH = os.path.join(_NATIVE_DIR, _LIB_NAME)

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> None:
    """``make -C native`` into a per-process name, renamed into place."""
    tmp = f"{_LIB_NAME}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(os.path.join(_NATIVE_DIR, tmp), LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        pass
    finally:
        if os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
            os.remove(os.path.join(_NATIVE_DIR, tmp))


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(LIB_PATH) and os.path.exists(
        os.path.join(_NATIVE_DIR, "Makefile")
    ):
        _build()
    if not os.path.exists(LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None

    lib.rspc_lzf_compress.restype = ctypes.c_uint64
    lib.rspc_lzf_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.rspc_lzf_decompress.restype = ctypes.c_uint64
    lib.rspc_lzf_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.rspc_load_dataset.restype = ctypes.c_int64
    lib.rspc_load_dataset.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def lzf_compress(data: bytes) -> Optional[bytes]:
    lib = _load()
    if lib is None or not data:
        return None
    cap = len(data) + len(data) // 16 + 96
    out = ctypes.create_string_buffer(cap)
    n = lib.rspc_lzf_compress(data, len(data), out, cap)
    if n == 0:
        return None
    return out.raw[:n]


def lzf_decompress(data: bytes, expected: int) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(expected)
    n = lib.rspc_lzf_decompress(data, len(data), out, expected)
    if n != expected:
        return None
    return out.raw


def load_dataset(paths, capacity: int):
    """Threaded native load of PCD files with the standard x/y/z/rgb
    float layout into padded ``[n, capacity]`` host arrays.

    Returns ``(xyz f32[n,cap,3], rgb f32[n,cap,3], valid bool[n,cap],
    counts i64[n])``, or None when the library is unavailable.
    ``counts[i] == -1`` marks a file the fast path could not parse; the
    caller loads that one through the general Python reader."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    xyz = np.empty((n, capacity, 3), np.float32)
    rgb = np.empty((n, capacity, 3), np.float32)
    valid = np.zeros((n, capacity), np.uint8)
    counts = np.zeros((n,), np.int64)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(os.fspath(p)) for p in paths])
    lib.rspc_load_dataset(
        arr, n, capacity,
        xyz.ctypes.data_as(ctypes.c_void_p),
        rgb.ctypes.data_as(ctypes.c_void_p),
        valid.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
    )
    return xyz, rgb, valid.astype(bool), counts
