"""The JAX package's native library, loaded, for the port tests that
compare with ``rspc_tpu.io.native``.

The JAX package's loader (``rspc_tpu/io/native.py``) runs ``make -C
native`` straight onto ``native/librspc_native.so`` when the file is
missing, and caches a failed load for the rest of the process. Under
several pytest workers on a fresh tree, two workers can link onto that
file at once, and a third can load it half-written; its ``KDTree`` then
raises and its ``available()`` stays False in that worker. The port
builds and loads its own copy (``rspc_tpu_torch/_build/``), so only the
JAX side needs this.
"""

from __future__ import annotations

import contextlib
import os
import time

from rspc_tpu.io import native as jnative
from rspc_tpu_torch.io import native as tnative

LOAD_TIMEOUT_S = 60.0


def jax_native():
    """``rspc_tpu.io.native`` with its library loaded. Where
    ``native/librspc_native.so`` is missing, build it as the port builds
    its own (locked, a temporary name, ``os.replace``), so that the JAX
    loader finds a whole file and runs no ``make`` of its own; where a
    load failed (a file another worker was still writing), load again,
    for at most ``LOAD_TIMEOUT_S``. Raises if it never loads."""
    lib_path = os.path.abspath(jnative._LIB_PATH)
    deadline = time.monotonic() + LOAD_TIMEOUT_S
    while True:
        if not os.path.exists(lib_path):
            tnative.build(lib_path)
        if jnative._lib is None:
            jnative._tried = False
        if jnative._load() is not None:
            return jnative
        if time.monotonic() > deadline:
            raise AssertionError(
                f"the JAX package's native library did not load in {LOAD_TIMEOUT_S:.0f} s "
                f"({lib_path}, exists: {os.path.exists(lib_path)})")
        time.sleep(0.5)


@contextlib.contextmanager
def python_codecs():
    """Both packages on their pure-Python codecs (their native libraries
    held as not loaded), restored on exit."""
    saved = [(m, m._lib, m._tried) for m in (tnative, jnative)]
    for m, _, _ in saved:
        m._lib, m._tried = None, True
    try:
        yield
    finally:
        for m, lib, tried in saved:
            m._lib, m._tried = lib, tried
