"""Canny edge detection with hysteresis (port of ``rspc_tpu/ops/canny.py``).

Pipeline: Gaussian 3x3 (sigma 1) smoothing -> Sobel gradients -> L2
magnitude -> 4-sector non-maximum suppression -> double threshold ->
hysteresis to a fixpoint (the unique 8-connected closure of the strong
pixels through weak pixels -- PCL's DFS edge tracing reaches the same
set).

Hysteresis is kernel B3: for CUDA tensors :func:`_hysteresis` launches
``csrc/hysteresis.cu`` (connected-components labelling of ``weak |
strong`` in three passes over 32x32 tiles, frames of any size); for CPU
tensors it runs the plain fixpoint (:func:`_hysteresis_plain`, the JAX
package's ``_propagate_line`` + ``_dilate8`` rounds). There is no
fallback between the two.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rspc_tpu_torch import cuda_build
from rspc_tpu_torch.ops.image import (
    SOBEL_X,
    SOBEL_Y,
    _conv_contracted,
    _fma,
    gaussian_kernel_3x3,
    shift2d,
    shift_hw,
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
    sectors (tangent-band comparisons, identical to the JAX package), on
    an ``[H, W]`` frame or an ``[n, H, W]`` stack."""
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
        (shift_hw(mag, 0, 1), shift_hw(mag, 0, -1)),    # horizontal gradient
        (shift_hw(mag, -1, 1), shift_hw(mag, 1, -1)),   # 45 deg
        (shift_hw(mag, -1, 0), shift_hw(mag, 1, 0)),    # vertical
        (shift_hw(mag, -1, -1), shift_hw(mag, 1, 1)),   # 135 deg
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


# csrc/hysteresis.cu: the tile side of passes 1 and 2, and the passes a
# call launches
TILE = 32
PASSES = 3
# a pixel's key is its flat index over the batch with bit 31 as a flag
MAX_PIXELS = 2**31


class HysteresisPlan(NamedTuple):
    """A launch of kernel B3 on a ``[frames, h, w]`` batch: the tile grid
    of one frame, the tiles of the batch (a block each in pass 1, a warp
    each in pass 2), and the int32 scratch words (4 words of border bits
    per tile, then a label per pixel)."""

    tiles_y: int
    tiles_x: int
    tiles: int
    scratch: int


def plan(frames: int, h: int, w: int) -> HysteresisPlan:
    """Kernel B3's launch plan; raises when the batch has ``MAX_PIXELS``
    pixels or more (the keys would overflow)."""
    pixels = frames * h * w
    if pixels >= MAX_PIXELS:
        raise ValueError(
            f"hysteresis: a batch of {frames} x {h} x {w} = {pixels} pixels; "
            f"the kernel takes fewer than 2**31"
        )
    tiles_y, tiles_x = -(-h // TILE), -(-w // TILE)
    tiles = frames * tiles_y * tiles_x
    return HysteresisPlan(tiles_y, tiles_x, tiles, 4 * tiles + pixels)


def hysteresis_cuda(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """Kernel B3 (``csrc/hysteresis.cu``), replacing the TPU kernel
    ``rspc_tpu/ops/canny.py::_hysteresis_kernel``.

    ``strong``/``weak``: bool ``[B, H, W]`` CUDA tensors; returns bool
    ``[B, H, W]``, bit for bit :func:`_hysteresis_plain` on each frame.
    The result is the union of the 8-connected components of ``weak |
    strong`` that hold a strong pixel, so the kernel labels components:
    union-find over the row runs of each 32x32 tile in shared memory (one
    block per tile of the batch), a merge across tile borders on global
    labels (never across a frame's edge or a row's end), and an output
    pass; see the source's note. One call launches the ``PASSES`` passes
    and counts one launch. Frames of any size run; the scratch is one
    int32 per pixel and four per tile (:func:`plan`)."""
    cuda_build.require_cuda("hysteresis strong", strong, torch.bool)
    if strong.dim() != 3:
        raise ValueError(f"hysteresis: expected [B, H, W], got {tuple(strong.shape)}")
    frames, h, w = strong.shape
    cuda_build.require_cuda("hysteresis weak", weak, torch.bool, strong.shape)
    p = plan(frames, h, w)
    scratch = torch.empty(p.scratch, dtype=torch.int32, device=strong.device)
    out = torch.empty_like(strong)
    code = cuda_build.library().rspc_hysteresis(
        strong.data_ptr(), weak.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        frames, h, w, p.tiles_y, p.tiles_x, cuda_build.stream_of(strong),
    )
    cuda_build.check(code, "rspc_hysteresis")
    cuda_build.LAUNCHES["hysteresis"] += 1
    return out


def _hysteresis(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """Grow strong edges through weak pixels to the fixpoint, for one
    ``[H, W]`` frame or a ``[B, H, W]`` batch (one kernel call for the
    batch). CUDA tensors launch kernel B3; CPU tensors take the plain
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
    and NMS: everything of Canny before the hysteresis.

    The smoothing, the Sobel passes and the magnitude round as the JAX
    package's jitted program does, multiply-adds fused: NMS keeps a pixel
    that ties its neighbour, and on flat synthetic texture exact ties are
    common, so how the arithmetic rounds decides which side of a ramp
    becomes the edge (evaluated op by op, both sides stay and the edges
    are about 10% thicker on the robustness matrix's scenes)."""
    smoothed = _conv_contracted(intensity, gaussian_kernel_3x3(1.0))
    gx = _conv_contracted(smoothed, SOBEL_X)
    gy = _conv_contracted(smoothed, SOBEL_Y)
    return canny_from_gradients_masks(gx, gy, low, high)


def canny_from_gradients_masks(gx, gy, low: float, high: float, valid=None):
    """(strong, weak) of Canny's NMS and double threshold on gradient
    images given from outside, ``[H, W]`` or ``[n, H, W]``; ``valid``
    zeroes the magnitude where it is False. The magnitude fuses ``gx *
    gx`` into the sum, as the JAX package's jitted program does."""
    mag = torch.sqrt(_fma(gx, gx, gy * gy))
    if valid is not None:
        mag = torch.where(valid, mag, 0.0)
    mag_nms = torch.where(_nms(mag, gx, gy), mag, 0.0)
    return mag_nms > high, mag_nms > low


def canny_from_gradients(gx, gy, low: float, high: float, valid=None):
    """Canny NMS + hysteresis on gradient images given from outside: how
    PCL derives HIGH_CURVATURE edges, with the normal image's (nx, ny) as
    the gradients (OrganizedEdgeFromNormals::extractEdges). An
    ``[n, H, W]`` stack is one hysteresis call (one launch of kernel B3
    on CUDA tensors)."""
    return _hysteresis(*canny_from_gradients_masks(gx, gy, low, high, valid))


def canny(intensity: torch.Tensor, low: float = 40.0, high: float = 100.0):
    """Canny on an intensity image (0..255 scale), PCL parameterization."""
    return _hysteresis(*canny_masks(intensity, low, high))
