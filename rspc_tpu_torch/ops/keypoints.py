"""Scale-space keypoints, SIFT-layout descriptors and 2-NN matching (port
of ``rspc_tpu/ops/keypoints.py``).

The reference's OpenCV SIFT (src/capture_opencv.hpp:30-48) and FLANN
2-NN matching with Lowe ratio 0.3, feeding a visual odometry whose output
the reference's caller discards (main.cpp:44-53). The recipe is the JAX
package's, whose docstrings give the measurements behind each choice:
a difference-of-Gaussian pyramid over a 2x-upsampled base octave
(``first_octave=-1``; 0 starts at the image itself) and ``num_octaves``
more, 3x3x3 extrema with contrast and edge tests, sub-pixel and
sub-scale refinement, fixed-capacity top-k selection; 128-d descriptors
on a rotated, scale-matched 16x16 grid with level-lerped bilinear
gradients and trilinear soft binning; one matrix product and a 2-NN
ratio test with an ambiguity guard, an optional scale-consistency gate
and an optional mutual check.

Keypoints are batched over the leading axis where the JAX package maps
one keypoint at a time. Three rules keep the results the same on the CPU
and the card, and the same from run to run:

  * top-k is a stable descending sort (``_top_k``): equal scores keep the
    lower index first, as ``jax.lax.top_k`` does, where ``torch.topk``
    promises no order among ties;
  * argmax and argmin take the first index on ties (``_first_argmax``),
    as ``jnp.argmax`` / ``jnp.argmin`` do;
  * the orientation histogram and the descriptor bins, a
    ``jax.ops.segment_sum`` in the JAX package, are products with one-hot
    bin weights (``torch.bmm``), which add in a fixed order; on the card
    ``index_add_`` adds with float atomics in an order that changes from
    run to run, and the dominant orientation's ``argmax`` and the 0.2
    clamp would follow the last bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from rspc_tpu_torch.ops.image import (
    _column_pass,
    _conv_contracted,
    _fma,
    separable_taps,
)


def _gauss_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _unit(gray: torch.Tensor) -> torch.Tensor:
    """0..255 gray to [0, 1]: XLA folds the JAX package's ``/ 255.0``
    into a multiply by the f32 reciprocal."""
    return gray.to(torch.float32) * float(np.float32(1.0 / 255.0))


def _blur_parts(img: torch.Tensor, sigma: float):
    """The Gaussian blur of the JAX package's ``_blur`` (``conv2d_same``
    with ``k[None, :]``, then ``k[:, None]``) as ``(s, c)``, the blur
    being ``s * c`` rounded: the first convolution's one-tap column pass
    and its row taps, then the second's column taps ``s``, each pass's
    multiply-adds contracted as the jitted program contracts them, and
    the second's one-tap row pass ``c``, which the jitted detector fuses
    into the DoG's subtraction (:func:`_detect_octave`)."""
    radius = max(1, int(3 * sigma + 0.5))
    k = _gauss_kernel1d(sigma, radius)
    rows = _conv_contracted(img, k[None, :])
    return _column_pass(rows, k[:, None]), float(separable_taps(k[:, None])[1][0])


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    s, c = _blur_parts(img, sigma)
    return s * c


def _upsample2_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """2x linear upsampling of one axis as XLA's CPU dot forms the JAX
    package's resize: each output is its two taps (0.25, 0.75), the lower
    input index first, summed by a fused multiply-add into the first
    product; the border outputs copy the edge sample."""
    x = x.movedim(axis, 0)
    prev = torch.cat([x[:1], x[:-1]])
    nxt = torch.cat([x[1:], x[-1:]])
    even = _fma(x, 0.75, prev * 0.25)
    odd = _fma(nxt, 0.25, x * 0.75)
    even[0] = x[0]
    odd[-1] = x[-1]
    out = torch.stack([even, odd], dim=1).reshape(2 * x.shape[0], *x.shape[1:])
    return out.movedim(0, axis)


def _upsample2(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling with half-pixel centres and edge clamping,
    which is what ``jax.image.resize(..., "linear")`` gives when it
    upsamples (its triangle weights renormalised at the border): columns
    first, then rows, as its two dots run."""
    return _upsample2_axis(_upsample2_axis(img, 1), 0)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of a 1-D tensor;
    equal values keep the lower index first."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the maximum along ``dim``, the first one on ties."""
    best = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    pos = torch.arange(n, device=x.device).reshape(shape).expand_as(x)
    return torch.where(x == best, pos, n).amin(dim=dim)


def _scale_space(img: torch.Tensor, num_scales: int, base_blur: float):
    """(Gaussian levels ``[S+3]`` of ``[H, W]``, DoG stack ``[S+2, H, W]``)
    of one octave. ``base_blur`` is the blur the base image already
    carries in this octave's pixel units (0 for a raw base, 1 for the
    2x-upsampled base, 1.6 for a chained base); each level blurs by the
    increment sqrt(s^2 - base_blur^2)."""
    k = 2.0 ** (1.0 / num_scales)
    sigmas = [1.6 * (k**i) for i in range(num_scales + 3)]
    incr = lambda s: float(np.sqrt(max(s * s - base_blur * base_blur, 1e-6)))
    # each level as (s, c), the blur s * c; the base itself as (img, None)
    parts = [_blur_parts(img, incr(s)) for s in sigmas[1:]]
    parts.insert(0, (img, None) if base_blur >= sigmas[0] else _blur_parts(img, incr(sigmas[0])))
    gauss = [s if c is None else s * c for s, c in parts]
    # the jitted program fuses the upper level's last multiply into the
    # subtraction: fma(s, c, -lower)
    dog = torch.stack([_fma(*parts[i + 1], -gauss[i]) for i in range(len(gauss) - 1)])
    return gauss, dog


def _detect_octave(
    img: torch.Tensor,
    max_keypoints: int,
    num_scales: int,
    contrast_threshold: float,
    edge_ratio: float,
    base_blur: float,
):
    """DoG extrema on one octave of the (already [0,1]-scaled) image
    (``base_blur``: :func:`_scale_space`). Returns (xy, score, valid,
    sigma) in this octave's units plus the next octave's base image."""
    k = 2.0 ** (1.0 / num_scales)
    gauss, dog = _scale_space(img, num_scales, base_blur)
    next_base = gauss[num_scales][::2, ::2]

    h, w = img.shape
    mid = dog[1:-1]  # candidate scales [S, H, W]

    # 3x3x3 neighbourhood max/min via (wrapping) shifts
    nmax = torch.full_like(mid, -math.inf)
    nmin = torch.full_like(mid, math.inf)
    for ds in (-1, 0, 1):
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if ds == 0 and dr == 0 and dc == 0:
                    continue
                shifted = torch.roll(dog, (-ds, -dr, -dc), (0, 1, 2))[1:-1]
                nmax = torch.maximum(nmax, shifted)
                nmin = torch.minimum(nmin, shifted)
    is_ext = (mid > nmax) | (mid < nmin)
    strong = torch.abs(mid) > contrast_threshold

    # edge rejection: 2x2 Hessian of the DoG at each pixel/scale
    dxx = torch.roll(mid, -1, 2) + torch.roll(mid, 1, 2) - 2 * mid
    dyy = torch.roll(mid, -1, 1) + torch.roll(mid, 1, 1) - 2 * mid
    dxy = 0.25 * (
        torch.roll(mid, (-1, -1), (1, 2))
        + torch.roll(mid, (1, 1), (1, 2))
        - torch.roll(mid, (-1, 1), (1, 2))
        - torch.roll(mid, (1, -1), (1, 2))
    )
    tr = dxx + dyy
    det = _fma(dxx, dyy, -(dxy * dxy))
    r = edge_ratio
    # XLA folds (r + 1)^2 * det * r into one constant times det
    r_det = float(np.float32((r + 1.0) ** 2 * r))
    not_edge = (det > 0) & (tr * tr * r < det * r_det)

    margin = 8  # keep away from borders
    row = torch.arange(h, device=img.device)[:, None]
    col = torch.arange(w, device=img.device)[None, :]
    interior = (row >= margin) & (row < h - margin) & (col >= margin) & (col < w - margin)

    score = torch.where(is_ext & strong & not_edge & interior, torch.abs(mid), 0.0)
    flat = score.amax(dim=0).reshape(-1)  # collapse scales
    s_best = _first_argmax(score, 0).reshape(-1)  # winning scale per pixel
    top_scores, top_idx = _top_k(flat, max_keypoints)
    ys = (top_idx // w).to(torch.float32)
    xs = (top_idx % w).to(torch.float32)
    valid = top_scores > 0
    s_top = s_best[top_idx]

    def gather_sp(vol):
        return vol.reshape(vol.shape[0], -1)[s_top, top_idx]

    # sub-pixel refinement: offset = -H^-1 g in x/y at the winning scale,
    # used only under 0.75 px and clamped to +-0.5 px
    gx_k = gather_sp(0.5 * (torch.roll(mid, -1, 2) - torch.roll(mid, 1, 2)))
    gy_k = gather_sp(0.5 * (torch.roll(mid, -1, 1) - torch.roll(mid, 1, 1)))
    axx, ayy, axy = gather_sp(dxx), gather_sp(dyy), gather_sp(dxy)
    det2 = _fma(axx, ayy, -(axy * axy))
    safe = torch.abs(det2) > 1e-12
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det2, 1.0), 0.0)
    off_x = -_fma(ayy, gx_k, -(axy * gy_k)) * inv_det
    off_y = -_fma(axx, gy_k, -(axy * gx_k)) * inv_det
    ok_off = safe & (torch.abs(off_x) < 0.75) & (torch.abs(off_y) < 0.75)
    xs = xs + torch.clamp(torch.where(ok_off, off_x, 0.0), -0.5, 0.5)
    ys = ys + torch.clamp(torch.where(ok_off, off_y, 0.0), -0.5, 0.5)

    # sub-scale refinement: quadratic fit along the scale axis
    up, down = dog[2:], dog[:-2]
    gs_k = gather_sp(0.5 * (up - down))
    gss_k = gather_sp(up + down - 2 * mid)
    safe_s = torch.abs(gss_k) > 1e-12
    off_s = torch.where(safe_s, -gs_k / torch.where(safe_s, gss_k, 1.0), 0.0)
    off_s = torch.clamp(off_s, -0.5, 0.5)
    # mid[i] lives at sigma = 1.6 * k^(i+1)
    lvl = s_top.to(torch.float32) + 1.0 + off_s
    sigma = 1.6 * torch.pow(torch.tensor(k, dtype=torch.float32, device=img.device), lvl)
    return torch.stack([xs, ys], dim=-1), top_scores, valid, sigma, next_base


def detect_keypoints(
    gray: torch.Tensor,
    max_keypoints: int = 512,
    num_scales: int = 3,
    contrast_threshold: float = 0.02,
    edge_ratio: float = 10.0,
    num_octaves: int = 3,
    first_octave: int = -1,
):
    """DoG extrema over octaves ``first_octave .. num_octaves-1`` of a
    grayscale ``[H, W]`` image (0..255): ``first_octave`` -1 (the
    default) starts at OpenCV's 2x-upsampled base, 0 at the image itself
    (taken as blur-free).

    Returns (xy f32[K,2] base-image pixel coords, score f32[K], valid
    bool[K], sigma f32[K] in base-image units), K = ``max_keypoints``:
    each octave offers its top K by |DoG| and one top-k merges them.
    Octaves after the first whose image would fall below 48 px on a side
    are skipped."""
    if first_octave not in (-1, 0):
        raise ValueError(f"first_octave must be -1 or 0, not {first_octave}")
    img = _unit(gray)
    per = []
    base = _upsample2(img) if first_octave < 0 else img
    for o in range(first_octave, num_octaves):
        h, w = base.shape
        if o > first_octave and min(h, w) < 48:
            break
        if o > first_octave:
            base_blur = 1.6
        else:
            base_blur = 1.0 if first_octave < 0 else 0.0
        xy, sc, valid, sig, next_base = _detect_octave(
            base, max_keypoints, num_scales, contrast_threshold, edge_ratio,
            base_blur=base_blur,
        )
        f = float(2.0**o)
        per.append((xy * f, sc, valid, sig * f))
        base = next_base
    if len(per) == 1:
        return per[0]
    xy, sc, valid, sig = (torch.cat([p[i] for p in per]) for i in range(4))
    top, idx = _top_k(torch.where(valid, sc, 0.0), max_keypoints)
    return xy[idx], top, valid[idx] & (top > 0), sig[idx]


def _grad(f: torch.Tensor):
    gx = 0.5 * (torch.roll(f, -1, 1) - torch.roll(f, 1, 1))
    gy = 0.5 * (torch.roll(f, -1, 0) - torch.roll(f, 1, 0))
    return gx, gy


def _bilinear(st: torch.Tensor, lvl: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Sample level ``lvl`` (i64 ``[K]``) of the stack ``st [L,H,W]`` at
    sub-pixel ``xs``/``ys`` (``[K, ...]``), clamped to the stack's own
    bounds."""
    h, w = st.shape[1], st.shape[2]
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 2)
    fx = torch.clamp(xs - x0.to(torch.float32), 0.0, 1.0)
    fy = torch.clamp(ys - y0.to(torch.float32), 0.0, 1.0)
    base = lvl.reshape(-1, *([1] * (xs.dim() - 1))) * (h * w) + y0 * w + x0
    flat = st.reshape(-1)
    f00, f01 = flat[base], flat[base + 1]
    f10, f11 = flat[base + w], flat[base + w + 1]
    return (
        f00 * (1 - fy) * (1 - fx)
        + f01 * (1 - fy) * fx
        + f10 * fy * (1 - fx)
        + f11 * fy * fx
    )


def _spatial_weights(ou: torch.Tensor, ov: torch.Tensor) -> torch.Tensor:
    """``f32[256, 16]``: each grid sample's bilinear weight in each of the
    4x4 spatial cells (``v * 4 + u``), zero outside the grid. The grid is
    the same for every keypoint, so this is a constant."""
    cu = (ou + 8.0) / 4.0 - 0.5
    cv = (ov + 8.0) / 4.0 - 0.5
    u0, v0 = torch.floor(cu), torch.floor(cv)
    fu, fv = cu - u0, cv - v0
    w = torch.zeros(256, 16, dtype=torch.float32, device=ou.device)
    for du in (0, 1):
        wu = (1 - fu) if du == 0 else fu
        uu = u0.to(torch.int64) + du
        for dv in (0, 1):
            wv = (1 - fv) if dv == 0 else fv
            vv = v0.to(torch.int64) + dv
            ok = (uu >= 0) & (uu < 4) & (vv >= 0) & (vv < 4)
            cell = (vv.clamp(0, 3) * 4 + uu.clamp(0, 3)).reshape(-1)
            w += F.one_hot(cell, 16) * (wu * wv * ok).reshape(-1, 1)
    return w


def compute_descriptors(
    gray: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    sigma: torch.Tensor | None = None,
    num_scales: int = 3,
    num_octaves: int = 3,
    first_octave: int = -1,
    num_orientations: int = 1,
):
    """128-d SIFT-layout descriptors (4x4 spatial x 8 orientation bins) of
    the keypoints ``xy f32[K,2]`` (``sigma`` from ``detect_keypoints``;
    None puts every keypoint at 1.6).

    Per keypoint: a 36-bin Gaussian-weighted orientation histogram,
    circularly smoothed twice, whose peak rotates the 16x16 sample grid;
    the grid is scaled by sigma/1.6 and samples gradients lerped between
    the two Gaussian levels that bracket the keypoint's scale (with
    ``first_octave`` -1, the 2x-upsampled stack for sigma < 1.6; with 0
    the levels start at sigma 1.6); contributions are soft-binned
    trilinearly under a Gaussian window; L2-normalise, clamp at 0.2,
    renormalise.

    Besides the dominant orientation, ``num_orientations`` = N > 1 emits
    descriptors at up to N-1 further histogram peaks (each at a circular
    distance of at least 3 bins from those chosen before) that reach 0.8x
    the dominant one, and returns ``(desc f32[N*K,128], valid
    bool[N*K])``, rows N*i .. N*i+N-1 belonging to keypoint i (the
    odometry uses N = 3). With N = 1 (the default) it returns ``desc
    f32[K,128]`` alone, zero for an invalid keypoint."""
    dev = gray.device
    img = _unit(gray)
    kk = 2.0 ** (1.0 / num_scales)
    log_kk = float(np.log(np.float32(kk)))
    lo = num_scales if first_octave < 0 else 0  # levels below sigma 1.6
    n_lvl = num_scales * num_octaves + 3 + lo
    gs = [_grad(_blur(img, 1.6 * (kk ** (i - lo)))) for i in range(n_lvl)]
    gx_st = torch.stack([g[0] for g in gs])  # [L,H,W]
    gy_st = torch.stack([g[1] for g in gs])
    # sub-1.6-sigma keypoints (the upsampled base octave's) sample a second,
    # short stack on the 2x-upsampled image
    n_ups = lo + 2 if first_octave < 0 else 0
    if n_ups:
        ups = _upsample2(img)
        gs_u = [_grad(_blur(ups, 2.0 * 1.6 * (kk ** (i - lo)))) for i in range(n_ups)]
        gxu_st = torch.stack([g[0] for g in gs_u])
        gyu_st = torch.stack([g[1] for g in gs_u])
    k = xy.shape[0]
    if sigma is None:
        sigma = torch.full((k,), 1.6, dtype=torch.float32, device=dev)

    offs = torch.arange(-8, 8, dtype=torch.float32, device=dev) + 0.5  # 16 samples
    ov, ou = torch.meshgrid(offs, offs, indexing="ij")  # [16,16] dv, du
    gauss_w = torch.exp(-(ou * ou + ov * ov) / (2.0 * 8.0 * 8.0))

    def grad_at(lvl, lvl1, lfrac, fine, xs, ys):
        """Level-lerped (gx, gy) at base-image coords ``[K',16,16]`` from
        the stack of each keypoint's octave."""
        lf = lfrac[:, None, None]
        gxf = (1.0 - lf) * _bilinear(gx_st, lvl, xs, ys) + lf * _bilinear(gx_st, lvl1, xs, ys)
        gyf = (1.0 - lf) * _bilinear(gy_st, lvl, xs, ys) + lf * _bilinear(gy_st, lvl1, xs, ys)
        if not n_ups:
            return gxf, gyf
        lvu = torch.clamp(lvl, max=n_ups - 1)
        lvu1 = torch.clamp(lvl1, max=n_ups - 1)
        gxu = (1.0 - lf) * _bilinear(gxu_st, lvu, 2 * xs, 2 * ys) \
            + lf * _bilinear(gxu_st, lvu1, 2 * xs, 2 * ys)
        gyu = (1.0 - lf) * _bilinear(gyu_st, lvu, 2 * xs, 2 * ys) \
            + lf * _bilinear(gyu_st, lvu1, 2 * xs, 2 * ys)
        f = fine[:, None, None]
        return torch.where(f, gxu, gxf), torch.where(f, gyu, gyf)

    cx, cy = xy[:, 0], xy[:, 1]
    scale = sigma / 1.6
    fine = scale < 1.0  # upsampled-base-octave keypoint
    lf = torch.clamp(
        torch.log(torch.clamp(scale, min=1e-6)) / log_kk + float(lo), 0.0, float(n_lvl - 1)
    )
    lvl = torch.floor(lf).to(torch.int64)
    lvl1 = torch.clamp(lvl + 1, max=n_lvl - 1)
    lfrac = lf - lvl.to(torch.float32)
    kp = (lvl, lvl1, lfrac, fine)

    # dominant orientation from the axis-aligned patch: 36-bin histogram
    s3 = scale[:, None, None]
    gx0, gy0 = grad_at(*kp, cx[:, None, None] + ou * s3, cy[:, None, None] + ov * s3)
    m0 = torch.sqrt(gx0 * gx0 + gy0 * gy0) * gauss_w
    a0 = torch.atan2(gy0, gx0)
    bins36 = torch.remainder(
        torch.floor((a0 + math.pi) / (2 * math.pi) * 36).to(torch.int64), 36
    )
    hist36 = torch.bmm(m0.reshape(k, 1, 256),
                       F.one_hot(bins36.reshape(k, 256), 36).to(torch.float32))[:, 0]
    for _ in range(2):  # circular [1,1,1]/3 smoothing
        hist36 = (hist36 + torch.roll(hist36, 1, 1) + torch.roll(hist36, -1, 1)) / 3.0
    peak1 = _first_argmax(hist36, 1)

    # further peaks: the best bin at a circular distance >= 3 from every
    # peak chosen before, kept at Lowe's 0.8x-of-max threshold
    peaks, oks = [peak1], []
    idx36 = torch.arange(36, device=dev)[None, :]
    masked, prev = hist36, peak1
    top = hist36.gather(1, peak1[:, None])[:, 0]
    for _ in range(num_orientations - 1):
        dist = torch.minimum(torch.remainder(idx36 - prev[:, None], 36),
                             torch.remainder(prev[:, None] - idx36, 36))
        masked = torch.where(dist >= 3, masked, -math.inf)
        p = _first_argmax(masked, 1)
        oks.append(torch.isfinite(masked.gather(1, p[:, None])[:, 0])
                   & (hist36.gather(1, p[:, None])[:, 0] >= 0.8 * top))
        peaks.append(p)
        prev = p

    # every (keypoint, orientation) descriptor at once, rows N*i + j
    n = num_orientations
    main = ((torch.stack(peaks, 1).reshape(-1).to(torch.float32) + 0.5)
            / 36 * 2 * math.pi - math.pi)
    rep = lambda t: t.repeat_interleave(n, 0)
    cosm, sinm = torch.cos(main)[:, None, None], torch.sin(main)[:, None, None]
    sn = rep(scale)[:, None, None]
    rx = rep(cx)[:, None, None] + (cosm * ou - sinm * ov) * sn
    ry = rep(cy)[:, None, None] + (sinm * ou + cosm * ov) * sn
    gxs, gys = grad_at(*(rep(t) for t in kp), rx, ry)
    m = torch.sqrt(gxs * gxs + gys * gys) * gauss_w
    a_rel = torch.remainder(
        torch.atan2(gys, gxs) - main[:, None, None] + 2 * math.pi, 2 * math.pi
    )
    # trilinear soft binning: the spatial part is a constant [256, 16]
    # matrix, the orientation part two one-hot bins per sample
    co = (a_rel / (2 * math.pi) * 8.0 - 0.5).reshape(-1, 256)
    o0 = torch.floor(co)
    fo = co - o0
    o0 = o0.to(torch.int64)
    w_o = (F.one_hot(torch.remainder(o0, 8), 8) * (1 - fo)[..., None]
           + F.one_hot(torch.remainder(o0 + 1, 8), 8) * fo[..., None])
    w_s = m.reshape(-1, 256, 1) * _spatial_weights(ou, ov)[None]
    desc = torch.bmm(w_s.transpose(1, 2), w_o).reshape(-1, 128)  # (v*4+u)*8 + o
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-12)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-12)

    valid_n = torch.stack([valid] + [valid & ok for ok in oks], 1).reshape(n * k)
    desc = torch.where(valid_n[:, None], desc, 0.0)
    return desc if n == 1 else (desc, valid_n)


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D tensor: the middle of its non-NaN values,
    the two middle ones weighted 0.5 each for an even count
    (``torch.nanmedian`` takes the lower of them); NaN when none. The
    arithmetic is that of ``jnp.quantile``'s linear method, on the
    device, with no host sync."""
    s = torch.sort(x).values  # NaN sorts last
    n = (~torch.isnan(x)).sum().to(x.dtype)
    q = 0.5 * (n - 1)
    low, high = torch.floor(q), torch.ceil(q)
    w_high = q - low
    # q <= n - 1; with no value q is -0.5 and s[0] the NaN answer
    lo_i, hi_i = torch.clamp(low, min=0).long(), torch.clamp(high, min=0).long()
    return s[lo_i] * (1 - w_high) + s[hi_i] * w_high


def match_descriptors(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    ratio: float = 0.3,
    sigma_a: torch.Tensor | None = None,
    sigma_b: torch.Tensor | None = None,
    scale_gate: float = 0.0,
    mutual_group: int = 0,
):
    """2-NN matching with Lowe's ratio test (reference ratio 0.3,
    capture_opencv.hpp:66): for each A row the two nearest valid B rows
    by L2, kept when d1 < ratio * d2 and the gap sqrt(d2) - sqrt(d1)
    exceeds 0.01 (exact duplicates otherwise win on float noise).

    Scale-consistency gate, on where ``scale_gate`` > 1 and both
    ``sigma_a`` and ``sigma_b`` are given (per descriptor row, expanded
    like the rows): the matches that pass the ratio test vote one global
    scale, the median of their log(sigma_b / sigma_a) (the two frames of a
    rigid scene share one camera motion); a match whose own log ratio lies
    farther than log(``scale_gate``) from it is dropped. With no
    survivor the gate is off.

    ``mutual_group`` = G > 0: keep a match only when B's chosen row's
    nearest valid A row belongs to the same A keypoint (rows grouped by
    G, the orientations of one keypoint).

    Returns (idx_b i64[K], good bool[K])."""
    # unit-norm descriptors: L2^2 = 2 - 2 a.b (TF32 is off package-wide)
    sim = desc_a @ desc_b.T
    d2 = torch.where(valid_b[None, :], 2.0 - 2.0 * sim, math.inf)
    # the two smallest per row, the lower index first on ties (top_k's rule)
    d_sorted, idx = torch.sort(d2, dim=1, stable=True)
    d1, d2nd, idx = d_sorted[:, 0], d_sorted[:, 1], idx[:, :2]
    r1 = torch.sqrt(torch.clamp(d1, min=0.0))
    r2 = torch.sqrt(torch.clamp(d2nd, min=1e-20))
    good = (
        valid_a
        & torch.isfinite(d1)
        & torch.isfinite(d2nd)
        & (r1 < ratio * r2)
        & (r2 - r1 > 0.01)
    )
    if scale_gate > 1.0 and sigma_a is not None and sigma_b is not None:
        lr = torch.log(torch.clamp(sigma_b[idx[:, 0]], min=1e-6)
                       / torch.clamp(sigma_a, min=1e-6))
        med = _nanmedian(torch.where(good, lr, math.nan))
        no_hyp = torch.isnan(med)
        med = torch.where(no_hyp, 0.0, med)
        good = good & (no_hyp | (torch.abs(lr - med) <= float(np.log(scale_gate))))
    if mutual_group:
        d2_back = torch.where(valid_a[:, None], 2.0 - 2.0 * sim, math.inf)
        best_a = _first_argmax(-d2_back, 0)  # nearest A row per B row
        back = best_a[idx[:, 0]]
        ka = torch.arange(desc_a.shape[0], device=back.device)
        good = good & (back // mutual_group == ka // mutual_group)
    return idx[:, 0], good
