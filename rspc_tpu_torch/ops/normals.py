"""Integral-image surface normals, AVERAGE_3D_GRADIENT (port of
``rspc_tpu/ops/normals.py::estimate_normals``): central-difference 3-D
gradients along rows and columns, box-smoothed over the
``normal_smoothing_size`` window (gradients straddling a depth
discontinuity carry weight 0), normal = cross(d/dx, d/dy), normalized and
flipped toward the viewpoint at the origin; and the radius-search
variant for unorganized clouds (``estimate_normals_radius``)."""

from __future__ import annotations

import contextlib

import torch

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud
from rspc_tpu_torch.config import EdgeConfig
from rspc_tpu_torch.ops.eig3 import eigh3
from rspc_tpu_torch.ops.image import box_sum, shift2d


def estimate_normals(cloud: OrganizedCloud, config: EdgeConfig = EdgeConfig()):
    """Returns ``(normals f32[H,W,3], normals_valid bool[H,W])``."""
    xyz = cloud.xyz
    valid = cloud.valid
    z = xyz[..., 2]

    right = shift2d(xyz, 0, 1)
    left = shift2d(xyz, 0, -1)
    down = shift2d(xyz, 1, 0)
    up = shift2d(xyz, -1, 0)
    vr = shift2d(valid, 0, 1, fill=False)
    vl = shift2d(valid, 0, -1, fill=False)
    vd = shift2d(valid, 1, 0, fill=False)
    vu = shift2d(valid, -1, 0, fill=False)

    thresh = config.max_depth_change_factor * torch.clamp(z.abs(), min=1.0)
    smooth_h = (
        vr & vl
        & ((right[..., 2] - z).abs() < thresh)
        & ((left[..., 2] - z).abs() < thresh)
    )
    smooth_v = (
        vd & vu
        & ((down[..., 2] - z).abs() < thresh)
        & ((up[..., 2] - z).abs() < thresh)
    )
    grad_x = torch.where(smooth_h[..., None], right - left, 0.0)
    grad_y = torch.where(smooth_v[..., None], down - up, 0.0)

    radius = max(int(config.normal_smoothing_size) // 2, 1)
    sum_gx = box_sum(grad_x, radius)
    sum_gy = box_sum(grad_y, radius)
    cnt_x = box_sum(smooth_h.to(xyz.dtype), radius)
    cnt_y = box_sum(smooth_v.to(xyz.dtype), radius)

    avg_gx = sum_gx / torch.clamp(cnt_x, min=1.0)[..., None]
    avg_gy = sum_gy / torch.clamp(cnt_y, min=1.0)[..., None]

    n = torch.linalg.cross(avg_gx, avg_gy, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    ok = valid & (cnt_x > 0) & (cnt_y > 0) & (norm[..., 0] > 1e-12)
    n = n / torch.clamp(norm, min=1e-12)
    flip = (n * xyz).sum(dim=-1) > 0  # PCL flipNormalTowardsViewpoint
    n = torch.where(flip[..., None], -n, n)
    n = torch.where(ok[..., None], n, 0.0)
    return n, ok


@contextlib.contextmanager
def _f32_matmuls():
    """Full-f32 matmuls on the card within the block, whatever the
    caller set (the package turns TF32 off at import; this holds it off
    where the moment sums depend on it)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def estimate_normals_radius(cloud: Cloud, radius: float, chunk: int = 2048):
    """Radius-search surface normals for unorganized clouds (PCL
    ``NormalEstimation`` with ``KdTree::radiusSearch``, as the
    reference's pcdVisualization example uses them,
    examples/visualizer/pcdVisualization.cpp:51-60): per point, the
    covariance of every valid point within ``radius`` (itself included);
    the normal is the eigenvector of the smallest eigenvalue, flipped
    toward the viewpoint at the origin.

    The radius search is an all-pairs sweep over ``chunk`` target rows
    at a time that accumulates each source's neighbour moments (count,
    sum x, the 6 unique terms of sum x x^T) by three matmuls, in full
    f32 (TF32 would bring back the cancellation the recentring avoids);
    one ``[N, chunk]`` mask tile at a time. Coordinates are recentred on
    the valid points' centroid so that the f32 moment cancellation stays
    far below surface curvature at metre-scale scenes.

    Returns ``(normals f32[N,3], valid bool[N])``; points with fewer than
    3 neighbours in the radius are invalid with a zero normal."""
    xyz, valid = cloud.xyz, cloud.valid
    dtype = xyz.dtype
    n = xyz.shape[0]
    r2 = radius * radius
    w_all = valid.to(dtype)
    centroid = (xyz * w_all[:, None]).sum(dim=0) / torch.clamp(w_all.sum(), min=1.0)
    s = torch.where(valid[:, None], xyz - centroid, 0.0)
    s_norm2 = (s * s).sum(dim=-1)
    cnt = torch.zeros((n,), dtype=dtype, device=xyz.device)
    sx = torch.zeros((n, 3), dtype=dtype, device=xyz.device)
    sxx = torch.zeros((n, 6), dtype=dtype, device=xyz.device)
    with _f32_matmuls():
        for b in range(0, n, chunk):
            t, tv = s[b:b + chunk], valid[b:b + chunk]
            d2 = s_norm2[:, None] + (t * t).sum(dim=-1)[None, :] - 2.0 * (s @ t.T)
            w = ((d2 <= r2) & tv[None, :]).to(dtype)  # [N, chunk]
            cnt = cnt + w.sum(dim=1)
            sx = sx + w @ t
            # unique second-moment columns: xx yy zz xy xz yz
            prod = torch.stack([t[:, 0] * t[:, 0], t[:, 1] * t[:, 1], t[:, 2] * t[:, 2],
                                t[:, 0] * t[:, 1], t[:, 0] * t[:, 2], t[:, 1] * t[:, 2]],
                               dim=-1)
            sxx = sxx + w @ prod

    denom = torch.clamp(cnt, min=1.0)[:, None]
    mu = sx / denom
    exx = sxx / denom
    m0, m1, m2 = mu[:, 0], mu[:, 1], mu[:, 2]
    c01 = exx[:, 3] - m0 * m1
    c02 = exx[:, 4] - m0 * m2
    c12 = exx[:, 5] - m1 * m2
    cov = torch.stack([
        torch.stack([exx[:, 0] - m0 * m0, c01, c02], dim=-1),
        torch.stack([c01, exx[:, 1] - m1 * m1, c12], dim=-1),
        torch.stack([c02, c12, exx[:, 2] - m2 * m2], dim=-1),
    ], dim=-2)
    _, evecs = eigh3(cov)  # ascending eigenvalues
    nrm = evecs[..., 0]
    ok = valid & (cnt >= 3.0)
    # flip toward the viewpoint at the origin of the original frame
    flip = (nrm * xyz).sum(dim=-1) > 0
    nrm = torch.where(flip[:, None], -nrm, nrm)
    return torch.where(ok[:, None], nrm, 0.0), ok
