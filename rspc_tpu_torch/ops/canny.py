"""Canny edge detection with hysteresis (port of ``rspc_tpu/ops/canny.py``).

Pipeline: Gaussian 3x3 (sigma 1) smoothing -> Sobel gradients -> L2
magnitude -> 4-sector non-maximum suppression -> double threshold ->
hysteresis to a fixpoint (the unique 8-connected closure of the strong
pixels through weak pixels -- PCL's DFS edge tracing reaches the same
set).

Hysteresis is kernel B3: for CUDA tensors :func:`_hysteresis` launches
``csrc/hysteresis.cu``; for CPU tensors it runs the plain fixpoint
(:func:`_hysteresis_plain`, the JAX package's ``_propagate_line`` +
``_dilate8`` rounds). There is no fallback between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from rspc_tpu_torch import cuda_build
from rspc_tpu_torch.ops.image import (
    SOBEL_X,
    SOBEL_Y,
    conv2d_same,
    gaussian_kernel_3x3,
    shift2d,
)


def _dilate8(mask: torch.Tensor) -> torch.Tensor:
    out = mask
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr or dc:
                out = out | shift2d(mask, dr, dc, fill=False)
    return out


def _nms(mag: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Keep local maxima along the gradient direction quantized to 4
    sectors (tangent-band comparisons, identical to the JAX package)."""
    t1 = float(np.float32(np.tan(np.pi / 8)))
    t2 = float(np.float32(np.tan(3 * np.pi / 8)))
    ax, ay = gx.abs(), gy.abs()
    same_sign = (gx * gy) >= 0.0
    sector = torch.where(
        ay < t1 * ax,
        0,
        torch.where(ay >= t2 * ax, 2, torch.where(same_sign, 1, 3)),
    )
    neighbors = [
        (shift2d(mag, 0, 1), shift2d(mag, 0, -1)),    # horizontal gradient
        (shift2d(mag, -1, 1), shift2d(mag, 1, -1)),   # 45 deg
        (shift2d(mag, -1, 0), shift2d(mag, 1, 0)),    # vertical
        (shift2d(mag, -1, -1), shift2d(mag, 1, 1)),   # 135 deg
    ]
    keep = torch.zeros(mag.shape, dtype=torch.bool, device=mag.device)
    for s, (n1, n2) in enumerate(neighbors):
        keep = torch.where(sector == s, (mag >= n1) & (mag >= n2), keep)
    return keep


def _propagate_line(cur: torch.Tensor, weak: torch.Tensor, dr: int,
                    dc: int) -> torch.Tensor:
    """Flood ``cur`` through ``weak`` runs along one scan direction in
    one log-doubling pass (see the JAX package for the recurrence)."""
    n = cur.shape[1] if dr == 0 else cur.shape[0]
    a, b, step = weak, cur, 1
    while step < n:
        b = b | (a & shift2d(b, dr * step, dc * step, fill=False))
        a = a & shift2d(a, dr * step, dc * step, fill=False)
        step *= 2
    return b


def _hysteresis_plain(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch hysteresis of one ``[H, W]`` frame: four directional
    line floods plus one 8-dilation per round until nothing changes. The
    stop test reads a device bool each round (a host sync)."""
    if strong.is_cuda:
        cuda_build.PLAIN_ON_CUDA["hysteresis"] += 1
    cur = strong
    while True:
        grown = cur
        for dr, dc in ((0, -1), (0, 1), (-1, 0), (1, 0)):
            grown = _propagate_line(grown, weak, dr, dc)
        grown = grown | (weak & _dilate8(grown))
        if not bool((grown != cur).any()):
            return grown
        cur = grown


def hysteresis_cuda(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """Kernel B3 (``csrc/hysteresis.cu``), replacing the TPU kernel
    ``rspc_tpu/ops/canny.py::_hysteresis_kernel``.

    ``strong``/``weak``: bool ``[B, H, W]`` CUDA tensors; returns bool
    ``[B, H, W]``. One CTA per frame holds the frame's weak and current
    masks bit-packed in shared memory (2 * H * ceil(W/32) words: 76.8 KB
    at 640x480) and iterates row and column sweeps to the fixpoint
    in-kernel, so the frame never returns to device memory until done.
    What bounds it on the card: the serial dependence along a chain of
    weak pixels (latency of shared-memory sweeps), not bytes or FLOPs;
    the sweeps carry a whole run per pass, so a round lights every pixel
    reachable without changing direction twice. Frames whose masks do
    not fit one block's shared memory raise."""
    cuda_build.require_cuda("hysteresis strong", strong, torch.bool)
    frames, h, w = strong.shape
    cuda_build.require_cuda("hysteresis weak", weak, torch.bool, strong.shape)
    lib = cuda_build.library()
    limit = cuda_build.smem_optin_limit()
    # two bit-packed masks, plus the kernel's static "changed" flag
    need = 2 * h * ((w + 31) // 32) * 4 + 16
    if need > limit:
        raise ValueError(
            f"hysteresis: a {h}x{w} frame needs {need} B of shared memory, "
            f"the card allows {limit} B per block"
        )
    out = torch.empty_like(strong)
    code = lib.rspc_hysteresis(
        strong.data_ptr(), weak.data_ptr(), out.data_ptr(), frames, h, w,
        cuda_build.stream_of(strong),
    )
    cuda_build.check(code, "rspc_hysteresis")
    cuda_build.LAUNCHES["hysteresis"] += 1
    return out


def _hysteresis(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """Grow strong edges through weak pixels to the fixpoint, for one
    ``[H, W]`` frame or a ``[B, H, W]`` batch (the batch is the kernel's
    grid). CUDA tensors launch kernel B3; CPU tensors take the plain
    version frame by frame."""
    if strong.is_cuda:
        batched = strong.dim() == 3
        out = hysteresis_cuda(
            (strong if batched else strong[None]).contiguous(),
            (weak if batched else weak[None]).contiguous(),
        )
        return out if batched else out[0]
    if strong.dim() == 3:
        return torch.stack(
            [_hysteresis_plain(s, w) for s, w in zip(strong, weak)]
        )
    return _hysteresis_plain(strong, weak)


def canny_masks(intensity: torch.Tensor, low: float, high: float):
    """(strong, weak) bool ``[H, W]`` after smoothing, Sobel, magnitude
    and NMS: everything of Canny before the hysteresis."""
    smoothed = conv2d_same(intensity, gaussian_kernel_3x3(1.0))
    gx = conv2d_same(smoothed, SOBEL_X)
    gy = conv2d_same(smoothed, SOBEL_Y)
    mag = torch.sqrt(gx * gx + gy * gy)
    keep = _nms(mag, gx, gy)
    mag_nms = torch.where(keep, mag, 0.0)
    return mag_nms > high, mag_nms > low


def canny(intensity: torch.Tensor, low: float = 40.0, high: float = 100.0):
    """Canny on an intensity image (0..255 scale), PCL parameterization."""
    return _hysteresis(*canny_masks(intensity, low, high))
