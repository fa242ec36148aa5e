"""ctypes binding to the repository's native I/O helpers (built from
``native/*.cpp``), the port's own copy of ``rspc_tpu/io/native.py``: the
LZF codec, the threaded dataset loader and the CPU kd-tree.

The port builds its own copy of the library, ``_build/librspc_native.so``
beside the CUDA kernels' builds, the first time it is needed, and never
loads the JAX package's ``native/librspc_native.so``. The build runs
under an exclusive lock on ``_build/librspc_native.lock``: ``make -C
native`` links into a per-process temporary name, which is renamed into
place (:func:`build`), so concurrent first uses (pytest workers, ranks) wait for one
build and never load a half-written file. Every entry point returns None
when the library does not build (no compiler), and the callers then take
their pure-Python versions, so the port never depends on a compiler.
These are host codecs, not device kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native")
)
_BUILD_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "_build"))
LIB_PATH = os.path.join(_BUILD_DIR, "librspc_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def build(lib_path: str = LIB_PATH) -> bool:
    """Build ``native/``'s library into ``lib_path`` unless it is there,
    under an exclusive lock on ``_build/librspc_native.lock``: ``make
    TARGET=`` a per-process temporary name beside it, then ``os.replace``.
    True when ``lib_path`` exists afterwards."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{os.path.splitext(lib_path)[0]}.{os.getpid()}.tmp.so"
    with open(os.path.join(_BUILD_DIR, "librspc_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(lib_path):
                subprocess.run(["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, lib_path)
        except (OSError, subprocess.SubprocessError):
            pass
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return os.path.exists(lib_path)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")) or not build():
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
    lib.rspc_kdtree_build.restype = ctypes.c_void_p
    lib.rspc_kdtree_build.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.rspc_kdtree_nn.restype = None
    lib.rspc_kdtree_nn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.rspc_kdtree_free.restype = None
    lib.rspc_kdtree_free.argtypes = [ctypes.c_void_p]
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


class KDTree:
    """CPU kd-tree nearest-neighbour oracle (the ``pcl::KdTreeFLANN``
    role, for checking device results; not on the device path). Raises
    RuntimeError when the library is unavailable."""

    def __init__(self, xyz: np.ndarray):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._xyz = np.ascontiguousarray(xyz, np.float32)
        self._handle = lib.rspc_kdtree_build(
            self._xyz.ctypes.data_as(ctypes.c_void_p), self._xyz.shape[0]
        )

    def query(self, queries: np.ndarray):
        """(squared distances f32[M], indices i32[M]) of each query's
        nearest point."""
        q = np.ascontiguousarray(queries, np.float32)
        m = q.shape[0]
        idx = np.empty(m, np.int32)
        d2 = np.empty(m, np.float32)
        self._lib.rspc_kdtree_nn(
            self._handle, q.ctypes.data_as(ctypes.c_void_p), m,
            idx.ctypes.data_as(ctypes.c_void_p), d2.ctypes.data_as(ctypes.c_void_p),
        )
        return d2, idx

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rspc_kdtree_free(self._handle)
            self._handle = None


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
