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
    """'Same' 2-D correlation of ``[H, W]`` with a small kernel,
    edge-replicated borders. A rank-1 kernel runs as the separable
    shift-multiply chain with the JAX package's term order (rows first,
    then columns, zero taps skipped), so results agree to the last few
    ulps; any other kernel as one ``conv2d`` of the padded image (TF32
    stays off, ``rspc_tpu_torch/__init__.py``)."""
    kh, kw = np.shape(kernel)
    h, w = img.shape
    p = _pad_edge_hw(img, kh // 2, kw // 2)
    taps = separable_taps(kernel)
    if taps is None:
        k = torch.as_tensor(np.asarray(kernel), dtype=img.dtype, device=img.device)
        return torch.nn.functional.conv2d(p[None, None], k[None, None])[0, 0]
    kv, kr = taps
    t = sum(float(kv[i]) * p[i:i + h, :] for i in range(kh) if kv[i] != 0.0)
    return sum(float(kr[j]) * t[:, j:j + w] for j in range(kw) if kr[j] != 0.0)


def separable_taps(kernel: np.ndarray):
    """The f32 column and row taps ``(kv, kr)`` of a rank-1 kernel, split
    by SVD as the JAX package splits it, or None for any other kernel."""
    kn = np.asarray(kernel, np.float64)
    u, s, vt = np.linalg.svd(kn)
    if not (s[0] > 0 and (len(s) == 1 or s[1] <= 1e-6 * s[0])):
        return None
    return ((u[:, 0] * np.sqrt(s[0])).astype(np.float32),
            (vt[0] * np.sqrt(s[0])).astype(np.float32))


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as a fused multiply-add does
    (the product of two f32 values is exact in f64)."""
    return (a.double() * b + c.double()).float()


def _contracted_sum(terms) -> torch.Tensor:
    """The sum of ``k * x`` over ``(k, x)`` terms in order, with the
    multiply-adds contracted as the JAX package's jitted program contracts
    them on the CPU: of the first two products, the one by a negative tap
    is rounded and the other fused (the first when the signs agree); every
    later product is fused into the running sum. One term is one multiply
    (the one-tap pass of a ``k[None, :]`` or ``k[:, None]`` kernel). The
    program around a sum can change the choice: see the callers."""
    if len(terms) == 1:
        k, x = terms[0]
        return x * k
    (k0, x0), (k1, x1) = terms[:2]
    if k0 < 0 <= k1:
        (k0, x0), (k1, x1) = (k1, x1), (k0, x0)
    acc = _fma(x0, k0, x1 * k1)
    for k, x in terms[2:]:
        acc = _fma(x, k, acc)
    return acc


def _column_pass(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """The column pass of :func:`_conv_contracted`: the edge-padded
    image's rows weighted by the kernel's column taps."""
    kv, kr = separable_taps(kernel)
    h = img.shape[0]
    p = _pad_edge_hw(img, len(kv) // 2, len(kr) // 2)
    return _contracted_sum([(float(k), p[i:i + h, :]) for i, k in enumerate(kv) if k != 0.0])


def _conv_contracted(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """:func:`conv2d_same` of ``[H, W]`` with a rank-1 kernel, each pass's
    taps summed by :func:`_contracted_sum`."""
    _, kr = separable_taps(kernel)
    t = _column_pass(img, kernel)
    w = img.shape[1]
    return _contracted_sum([(float(k), t[:, j:j + w]) for j, k in enumerate(kr) if k != 0.0])


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


def shift_hw(img: torch.Tensor, dr: int, dc: int, fill=0.0) -> torch.Tensor:
    """``out[..., r, c] = img[..., r + dr, c + dc]`` on the LAST two axes
    (``[..., H, W]`` stacks of frames, where :func:`shift2d` would shift
    across frames); out-of-range pixels take ``fill``."""
    h, w = img.shape[-2:]
    out = torch.full_like(img, fill)
    if abs(dr) >= h or abs(dc) >= w:
        return out
    out[..., max(-dr, 0):h - max(dr, 0), max(-dc, 0):w - max(dc, 0)] = img[
        ..., max(dr, 0):h - max(-dr, 0), max(dc, 0):w - max(-dc, 0)
    ]
    return out


def gaussian_kernel_3x3(sigma: float = 1.0) -> np.ndarray:
    ax = np.arange(-1, 2, dtype=np.float64)
    g = np.exp(-(ax**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], np.float32)
