"""Small shared image ops (port of ``rspc_tpu/ops/image.py``): 2-D
correlation, box sums, shifts. Images are ``[H, W]`` or ``[H, W, C]``
with H and W the first two axes, as in the JAX package."""

from __future__ import annotations

import numpy as np
import torch


def _pad_edge_hw(img: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge-replicate ``ph`` rows / ``pw`` columns on both sides."""
    rows = torch.cat([img[:1].expand(ph, *img.shape[1:]), img,
                      img[-1:].expand(ph, *img.shape[1:])], dim=0)
    return torch.cat([rows[:, :1].expand(rows.shape[0], pw, *img.shape[2:]),
                      rows,
                      rows[:, -1:].expand(rows.shape[0], pw, *img.shape[2:])],
                     dim=1)


def conv2d_same(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """'Same' 2-D correlation of ``[H, W]`` with a small rank-1 kernel,
    edge-replicated borders. Runs as the separable shift-multiply chain
    with the JAX package's term order (rows first, then columns, zero
    taps skipped), so results agree to the last few ulps."""
    kn = np.asarray(kernel, np.float64)
    kh, kw = kn.shape
    u, s, vt = np.linalg.svd(kn)
    if not (s[0] > 0 and (len(s) == 1 or s[1] <= 1e-6 * s[0])):
        raise NotImplementedError(
            "only separable kernels are ported (ROADMAP.md Queue A)"
        )
    kv = (u[:, 0] * np.sqrt(s[0])).astype(np.float32)
    kr = (vt[0] * np.sqrt(s[0])).astype(np.float32)
    h, w = img.shape
    p = _pad_edge_hw(img, kh // 2, kw // 2)
    t = sum(float(kv[i]) * p[i:i + h, :] for i in range(kh) if kv[i] != 0.0)
    return sum(float(kr[j]) * t[:, j:j + w] for j in range(kw) if kr[j] != 0.0)


def box_sum(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum over a (2r+1)^2 window via two cumulative passes (the
    integral-image trick); ``[H, W]`` and ``[H, W, C]``."""
    r = radius

    def sum_axis(x, axis):
        n = x.shape[axis]
        c = torch.cumsum(x, dim=axis)
        zeros = torch.zeros_like(c.narrow(axis, 0, 1)).expand(
            *[r + 1 if a == axis else s for a, s in enumerate(c.shape)]
        )
        lo = torch.cat([zeros, c], dim=axis).narrow(axis, 0, n)
        last = c.narrow(axis, n - 1, 1).expand(
            *[r if a == axis else s for a, s in enumerate(c.shape)]
        )
        hi = torch.cat([c, last], dim=axis).narrow(axis, r, n)
        return hi - lo

    return sum_axis(sum_axis(img, 0), 1)


def shift2d(img: torch.Tensor, dr: int, dc: int, fill=0.0) -> torch.Tensor:
    """``out[r, c] = img[r + dr, c + dc]`` on the first two axes;
    out-of-range pixels take ``fill``."""
    h, w = img.shape[:2]
    out = torch.full_like(img, fill)
    if abs(dr) >= h or abs(dc) >= w:
        return out
    out[max(-dr, 0):h - max(dr, 0), max(-dc, 0):w - max(dc, 0)] = img[
        max(dr, 0):h - max(-dr, 0), max(dc, 0):w - max(-dc, 0)
    ]
    return out


def gaussian_kernel_3x3(sigma: float = 1.0) -> np.ndarray:
    ax = np.arange(-1, 2, dtype=np.float64)
    g = np.exp(-(ax**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32)
