"""Build and bind the hand-written CUDA kernels of ``csrc/``.

On first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
``nvcc`` process per source, all started together) and links the
objects into one shared library with a plain C interface, under
``_build/`` keyed by a hash of the sources (so an edited kernel rebuilds
and a cached build is reused), and ``ctypes`` binds it. Nothing here
runs at import: the CPU test suite imports every module on a machine
without ``nvcc``.

Each C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`check` raises on a
nonzero code. ``LAUNCHES`` counts kernel launches per wrapper and
``PLAIN_ON_CUDA`` counts calls of a plain PyTorch version on CUDA tensors
(only a kernel-vs-plain comparison makes those), so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

LAUNCHES = {"nn_sweep": 0, "nn_sweep_split": 0, "hysteresis": 0}
PLAIN_ON_CUDA = {"nn_sweep": 0, "nn_sweep_split": 0, "hysteresis": 0}

# C signatures: (name, argument types); every function returns int
# (cudaError_t).
_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # src4, tgt4, live_hi, n, best_score, best_idx, stream
    "rspc_nn_sweep": (_VP, _VP, _VP, _I, _VP, _VP, _VP),
    # src4, tgt4, live_hi, n, splits, part_score, part_idx, best_score,
    # best_idx, stream
    "rspc_nn_sweep_split": (_VP, _VP, _VP, _I, _I, _VP, _VP, _VP, _VP, _VP),
    # strong, weak, out, frames, h, w, stream
    "rspc_hysteresis": (_VP, _VP, _VP, _I, _I, _I, _VP),
    # max dynamic shared memory per block (bytes) -> int*
    "rspc_hysteresis_smem_limit": (_VP,),
}

def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(procs, what: str) -> str:
    """Wait for every process, then raise with the output of the first
    that failed (so none is left running)."""
    done = [(cmd, proc, *proc.communicate()) for cmd, proc in procs]
    for cmd, proc, stdout, stderr in done:
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    return "".join(stdout + stderr for _, _, stdout, stderr in done)


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` (if not already built for these sources)
    and return the shared library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"librspc_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    tag = f"{source_hash()}.{os.getpid()}"
    nvcc = _nvcc()
    procs, objs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c",
               "-Xcompiler", "-fPIC", "-o", str(obj), str(src)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    log = _run(procs, "nvcc")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    log += _run([(cmd, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))], "nvcc link")
    for obj in objs:
        obj.unlink()
    if verbose and log:
        print(log, flush=True)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The bound kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def smem_optin_limit() -> int:
    """Largest dynamic shared memory one block may opt into (bytes)."""
    v = ctypes.c_int(0)
    check(library().rspc_hysteresis_smem_limit(ctypes.addressof(v)),
          "rspc_hysteresis_smem_limit")
    return v.value


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, where given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
