"""Alignment-quality measurements (port of
``rspc_tpu/registration/measures.py``): the dispatching NN sweep,
capped-score reductions and inlier statistics."""

from __future__ import annotations

import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.ops.nn import nn_sweep


def _nn_sweep(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk=2048):
    """NN sweep dispatched by device: kernel B1 for CUDA tensors, the
    plain chunked sweep (``chunk``-row tiles) for CPU tensors. The JAX
    package's ``use_pallas`` switch has no counterpart: the device of the
    tensors decides."""
    return nn_sweep(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk)


def _capped_sum(d2, valid, cap: float):
    """Sum of min(NN dist^2, cap^2) over valid rows, and the row count."""
    cap2 = cap * cap
    d2c = torch.clamp(torch.where(torch.isfinite(d2), d2, cap2), max=cap2)
    w = valid.to(d2.dtype)
    return (d2c * w).sum(dim=-1), w.sum(dim=-1)


def _capped_mean_sq(src: Cloud, tgt: Cloud, cap: float):
    """Mean of min(NN dist^2, cap^2) over valid source points."""
    d2, _ = _nn_sweep(src.xyz, src.valid, tgt.xyz, tgt.valid)
    s, n = _capped_sum(d2, src.valid, cap)
    return s / torch.clamp(n, min=1.0)


def _inlier_stats(src: Cloud, tgt: Cloud, radius: float):
    """(inlier count, inlier mean sq dist) within ``radius``."""
    d2, _ = _nn_sweep(src.xyz, src.valid, tgt.xyz, tgt.valid)
    inl = src.valid & torch.isfinite(d2) & (d2 < radius * radius)
    n = inl.to(src.xyz.dtype).sum()
    mean_sq = torch.where(inl, d2, 0.0).sum() / torch.clamp(n, min=1.0)
    mean_sq = torch.where(n > 0, mean_sq, float("inf"))
    return n, mean_sq
