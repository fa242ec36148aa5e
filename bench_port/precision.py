"""The precisions a reference runs in: the reference's own, and the
control's, the nearest below the configuration's float32 with TF32 off
(the port turns TF32 off at import): TF32 matmuls and convolutions."""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float64", "float32", "tf32")


def compute_dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 on for matmuls and convolutions under ``"tf32"``, off
    otherwise, restored on exit."""
    compute_dtype(precision)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
