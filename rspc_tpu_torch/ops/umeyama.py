"""Weighted rigid and point-to-plane transform estimation (port of
``rspc_tpu/ops/umeyama.py``).

``rigid_fit`` keeps the JAX package's Newton **polar iteration** for the
optimal rotation (quadratically convergent to f32 precision in ~10 3x3
steps), with the SVD path only as the reflection / degenerate fallback.
``plane_fit`` solves the linearized point-to-plane normal equations with
eigenvalue-floored 6x6 solves. Both take optional leading batch
dimensions (``[..., N, 3]`` inputs), which replace the JAX ``vmap``.
Both take an optional process group (``ops/collectives.py``) over whose
ranks the pairs are sharded: their additive moments are all-reduced
before the solve, so every rank returns the same global fit.
"""

from __future__ import annotations

import torch

from rspc_tpu_torch.ops.collectives import psum
from rspc_tpu_torch.utils import profiling


def _homogeneous(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([r, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 3:].fill_(1.0)  # fill_ takes the scalar by value: no copy
    return torch.cat([top, bottom], dim=-2)


def _adjugate3(m: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix of a 3x3: m^{-T} = cof(m) / det(m)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    rows = [
        [e * i - f * h, f * g - d * i, d * h - e * g],
        [c * h - b * i, a * i - c * g, b * g - a * h],
        [b * f - c * e, c * d - a * f, a * e - b * d],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _det3(m: torch.Tensor) -> torch.Tensor:
    return (m[..., 0, :] * _adjugate3(m)[..., 0, :]).sum(dim=-1)


def _fro(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.matrix_norm(m)


def _polar_rotation(x: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Orthogonal polar factor of a nonsingular det>0 3x3 by the
    norm-scaled Newton iteration X <- (g X + X^{-T}/g) / 2."""
    x = x / torch.clamp(_fro(x), min=1e-30)[..., None, None]
    for _ in range(iters):
        cof = _adjugate3(x)
        det = (x[..., 0, :] * cof[..., 0, :]).sum(dim=-1)
        x_invt = cof / det[..., None, None]
        g = torch.sqrt(
            torch.clamp(_fro(x_invt), min=1e-30) / torch.clamp(_fro(x), min=1e-30)
        )[..., None, None]
        x = 0.5 * (g * x + x_invt / g)
    return x


def fit_moments(src, dst, weights):
    """Raw weighted moments (sw, ss[3], sd[3], m[3,3]) with
    m = sum w src dst^T."""
    w = weights.to(src.dtype)
    sw = w.sum(dim=-1)
    ss = (src * w[..., None]).sum(dim=-2)
    sd = (dst * w[..., None]).sum(dim=-2)
    m = (src * w[..., None]).transpose(-1, -2) @ dst
    return sw, ss, sd, m


def rigid_fit_from_moments(sw, ss, sd, m) -> torch.Tensor:
    """Rigid transform from raw moments: demeaned H = m - ss sd^T / sw;
    R = argmax tr(R H); t = cd - R cs."""
    swc = torch.clamp(sw, min=1e-12)[..., None]
    cs = ss / swc
    cd = sd / swc
    h = m - ss[..., :, None] * sd[..., None, :] / swc[..., None]
    h_norm = torch.clamp(_fro(h), min=1e-30)[..., None, None]
    det_rel = _det3(h / h_norm)
    r_newton = _polar_rotation(h.transpose(-1, -2))
    # SVD fallback with reflection correction (degenerate/planar sets);
    # on the card torch.linalg.svd blocks the host twice (two reports of
    # torch's sync debug mode at this line, torch 2.11 + CUDA 12.8)
    with profiling.wait("fit_svd", syncs=2):
        u, _, vt = torch.linalg.svd(h)
    v = vt.transpose(-1, -2)
    det = _det3(v @ u.transpose(-1, -2))
    dvec = torch.stack(
        [torch.ones_like(det), torch.ones_like(det), det], dim=-1
    )
    r_svd = (v * dvec[..., None, :]) @ u.transpose(-1, -2)
    r = torch.where((det_rel > 1e-4)[..., None, None], r_newton, r_svd)
    t = cd - (r @ cs[..., :, None])[..., 0]
    return _homogeneous(r, t)


def rigid_fit(src, dst, weights, group=None) -> torch.Tensor:
    """Least-squares rigid T with ``T @ src ~= dst`` (PCL
    TransformationEstimationSVD semantics, no scaling). With ``group``
    the 16 moment scalars are summed over its ranks first."""
    return rigid_fit_from_moments(*psum(fit_moments(src, dst, weights), group))


def _rodrigues(omega: torch.Tensor) -> torch.Tensor:
    """exp([omega]_x), exact rotation from an axis-angle vector."""
    theta = torch.linalg.vector_norm(omega, dim=-1)
    small = theta < 1e-6
    safe = torch.where(small, 1.0, theta)
    a = torch.where(small, 1.0 - theta**2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta**2 / 24.0, (1.0 - torch.cos(safe)) / safe**2)
    k = _skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrices."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def plane_fit_moments(src, dst, normal, weights, offset=None):
    """(H [..., 6, 6], g [..., 6]) of the linearized point-to-plane
    problem: rows a = [src x n ; n], residuals r = n . (src - dst)
    (+ ``offset``). With ``n`` the target's intensity gradient and
    ``offset = I_dst - I_src`` these are the colored-ICP rows."""
    w = weights.to(src.dtype)
    a = torch.cat([torch.linalg.cross(src, normal, dim=-1), normal], dim=-1)
    r = ((src - dst) * normal).sum(dim=-1)
    if offset is not None:
        r = r + offset
    aw = a * w[..., None]
    h = aw.transpose(-1, -2) @ a
    g = (aw.transpose(-1, -2) @ r[..., None])[..., 0]
    return h, g


def point_fit_moments(src, dst, weights):
    """(H [..., 6, 6], g [..., 6]) of the LINEARIZED point-to-point
    problem: residual r = src - dst, Jacobian [-[src]_x | I] in
    (omega, t). Blended into the point-to-plane solve by ``point_mix``."""
    w = weights.to(src.dtype)
    eye = torch.eye(3, dtype=src.dtype, device=src.device).expand(*src.shape, 3)
    a = torch.cat([-_skew(src), eye], dim=-1)  # [..., N, 3, 6]
    aw = a * w[..., None, None]
    h = torch.einsum("...nij,...nik->...jk", aw, a)
    g = torch.einsum("...nij,...ni->...j", aw, src - dst)
    return h, g


def plane_fit_from_moments(h, g) -> torch.Tensor:
    """Solve the 6x6 normal equations with eigenvalues floored at
    1e-3 * lambda_max (unobserved directions stay put); f32[..., 4, 4]."""
    evals, evecs = torch.linalg.eigh(h)
    floor = 1e-3 * torch.clamp(evals[..., -1], min=1e-12)
    evals_f = torch.maximum(evals, floor[..., None])
    proj = (evecs.transpose(-1, -2) @ g[..., None])[..., 0] / evals_f
    x = -(evecs @ proj[..., None])[..., 0]
    x = torch.where(torch.isfinite(x).all(dim=-1, keepdim=True), x, 0.0)
    return _homogeneous(_rodrigues(x[..., :3]), x[..., 3:])


def plane_fit(src, dst, normal, weights, point_mix: float = 0.0, cgrad=None,
              color_resid=None, color_weights=None, group=None) -> torch.Tensor:
    """Least-squares rigid transform minimizing point-to-plane error
    (one linearized Gauss-Newton step). Lever arms are taken about the
    weighted source centroid to decouple rotation from translation; the
    solved motion is recomposed as a world transform.

    ``cgrad``/``color_resid``/``color_weights`` add the colored-ICP rows
    (direction the target's intensity gradient, residual offset ``I_dst
    - I_src``, their own weights, default ``weights``) about the same
    centroid. ``point_mix`` > 0 blends in the point-to-point moments,
    constraining directions the normal set leaves unobserved (a mix of
    0 adds exactly zero moments in the JAX package, so skipping the term
    gives the same bits). With ``group`` the centroid's 4 scalars and then
    the 42 of the 6x6 system are summed over its ranks."""
    w = weights.to(src.dtype)
    sw, sc = psum((w.sum(dim=-1), (src * w[..., None]).sum(dim=-2)), group)
    c = sc / torch.clamp(sw, min=1e-12)[..., None]
    s_c, d_c = src - c[..., None, :], dst - c[..., None, :]
    h, g = plane_fit_moments(s_c, d_c, normal, weights)
    if cgrad is not None:
        hc, gc = plane_fit_moments(
            s_c, d_c, cgrad, weights if color_weights is None else color_weights,
            offset=color_resid,
        )
        h, g = h + hc, g + gc
    if point_mix > 0.0:
        hp, gp = point_fit_moments(s_c, d_c, weights)
        h, g = h + point_mix * hp, g + point_mix * gp
    h, g = psum((h, g), group)
    t_c = plane_fit_from_moments(h, g)
    r = t_c[..., :3, :3]
    t = t_c[..., :3, 3] + c - (r @ c[..., :, None])[..., 0]
    return _homogeneous(r, t)
