"""Integral-image surface normals, AVERAGE_3D_GRADIENT (port of
``rspc_tpu/ops/normals.py::estimate_normals``): central-difference 3-D
gradients along rows and columns, box-smoothed over the
``normal_smoothing_size`` window (gradients straddling a depth
discontinuity carry weight 0), normal = cross(d/dx, d/dy), normalized and
flipped toward the viewpoint at the origin. The radius-search variant is
not ported yet (ROADMAP.md Queue A)."""

from __future__ import annotations

import torch

from rspc_tpu_torch.cloud import OrganizedCloud
from rspc_tpu_torch.config import EdgeConfig
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
