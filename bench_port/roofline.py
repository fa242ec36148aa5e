"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the least time a function
could take on it, copied from ``chip_smoke.py::bound``."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FMA_PER_S = 33.5e12  # 67 TFLOP/s of FP32 outside the tensor cores
NN_OPS_PER_PAIR = 4  # 3 for s.t, 1 for |t|^2 + pen - 2 s.t
NN_BYTES_PER_SOURCE = 12 + 1 + 8  # xyz and mask read, dist2 and index written
NN_BYTES_PER_TARGET = 12 + 1  # xyz and mask read


def bound_s(nbytes: float, ops: float) -> tuple[float, str]:
    """(least seconds, what bounds them) for a function that moves
    ``nbytes`` bytes and does ``ops`` FP32 FMA-class operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_FMA_PER_S
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def nn_bound_s(sources: int, targets: int) -> tuple[float, str]:
    """Bound of one NN sweep of ``sources`` valid sources against
    ``targets`` valid target rows: every valid source against every
    valid target, each input read once and each output written once."""
    return bound_s(NN_BYTES_PER_SOURCE * sources + NN_BYTES_PER_TARGET * targets,
                   NN_OPS_PER_PAIR * sources * targets)
