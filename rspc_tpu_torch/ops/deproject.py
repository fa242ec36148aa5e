"""Depth-frame deprojection and RGB texture mapping (port of
``rspc_tpu/ops/deproject.py``, pinhole model without distortion).

Camera model: ``x = (u - ppx) / fx``, ``y = (v - ppy) / fy``,
``point = depth * (x, y, 1)``; the texture lookup uses the reference's
clamp-to-edge pixel convention ``x = clamp(int(u*W + .5), 0, W-1)``.
Brown-Conrady undistortion is not ported yet (ROADMAP.md Queue A).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rspc_tpu_torch.cloud import OrganizedCloud


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """Pinhole + Brown-Conrady intrinsics (rs2_intrinsics equivalent)."""

    width: int
    height: int
    fx: float
    fy: float
    ppx: float
    ppy: float
    coeffs: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)

    @staticmethod
    def simple(width: int, height: int, fov_deg: float = 60.0) -> "Intrinsics":
        f = width / (2.0 * np.tan(np.radians(fov_deg) / 2.0))
        return Intrinsics(width, height, f, f, width / 2.0, height / 2.0)


def pixel_grid(h: int, w: int, device):
    """(u, v) f32[H, W] column and row index images."""
    u = torch.arange(w, dtype=torch.float32, device=device).expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    return u, v


def deproject_depth(
    depth: torch.Tensor, intr: Intrinsics, depth_scale: float = 0.001
) -> torch.Tensor:
    """Integer Z16 (or float metres) depth ``[H, W]`` -> organized
    ``f32[H, W, 3]`` xyz; zero depth yields the origin."""
    if any(c != 0.0 for c in intr.coeffs):
        raise NotImplementedError(
            "Brown-Conrady undistortion is not ported yet (ROADMAP.md Queue A)"
        )
    h, w = depth.shape
    if depth.dtype == torch.float32:
        z = depth
    else:
        z = depth.to(torch.float32) * depth_scale
    u, v = pixel_grid(h, w, depth.device)
    x = (u - intr.ppx) / intr.fx
    y = (v - intr.ppy) / intr.fy
    return torch.stack([x * z, y * z, z], dim=-1)


def project_points(xyz: torch.Tensor, intr: Intrinsics):
    """Project points to normalized texture coordinates (u, v)."""
    z = torch.where(xyz[..., 2] != 0.0, xyz[..., 2], 1.0)
    px = xyz[..., 0] / z * intr.fx + intr.ppx
    py = xyz[..., 1] / z * intr.fy + intr.ppy
    return px / intr.width, py / intr.height


def sample_texture(color: torch.Tensor, u, v, bgr: bool) -> torch.Tensor:
    h, w = color.shape[:2]
    xi = torch.clamp((u * w + 0.5).to(torch.int32), 0, w - 1).long()
    yi = torch.clamp((v * h + 0.5).to(torch.int32), 0, h - 1).long()
    rgb = color[yi, xi].to(torch.float32)
    if bgr:
        rgb = rgb.flip(-1)
    return rgb


def rgbd_to_organized_cloud(
    depth: torch.Tensor,
    color: torch.Tensor,
    intr: Intrinsics,
    depth_scale: float = 0.001,
    bgr: bool = True,
) -> OrganizedCloud:
    """Depth deprojection fused with the texture lookup; the depth and
    color streams are assumed registered (same grid)."""
    xyz = deproject_depth(depth, intr, depth_scale)
    u, v = project_points(xyz, intr)
    rgb = sample_texture(color, u, v, bgr)
    valid = xyz[..., 2] > 0.0
    rgb = torch.where(valid[..., None], rgb, 0.0)
    return OrganizedCloud(xyz=xyz, rgb=rgb, valid=valid)
