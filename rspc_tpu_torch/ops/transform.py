"""Rigid 3-D transforms (port of ``rspc_tpu/ops/transform.py``).

Transforms are homogeneous ``f32[..., 4, 4]`` acting on column vectors,
``p' = T @ [p;1]``; points are row-major ``[..., N, 3]``. Leading batch
dimensions broadcast (they replace the JAX package's ``vmap``).
"""

from __future__ import annotations

import torch

from rspc_tpu_torch.cloud import Cloud, map_optional


def rotation_matrix(angle: torch.Tensor, axis: int) -> torch.Tensor:
    """3x3 rotation about a coordinate axis (0=X, 1=Y, 2=Z), Eigen
    ``AngleAxisf(angle, Unit<axis>())`` semantics (right-handed, CCW)."""
    c, s = torch.cos(angle), torch.sin(angle)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    if axis == 0:
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    elif axis == 1:
        rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    elif axis == 2:
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    else:
        raise ValueError(f"axis must be 0..2, got {axis}")
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotate_points(rot: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """``xyz @ rot^T`` as explicit per-component products, the same term
    order as the JAX package (exact f32, no reduced-precision matmul)."""
    c = [
        xyz[..., 0] * rot[..., i, 0, None]
        + xyz[..., 1] * rot[..., i, 1, None]
        + xyz[..., 2] * rot[..., i, 2, None]
        for i in range(3)
    ]
    return torch.stack(c, dim=-1)


def apply_transform(transform: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to ``[..., N, 3]`` points."""
    rot = transform[..., :3, :3]
    t = transform[..., :3, 3]
    return rotate_points(rot, xyz) + t[..., None, :]


def apply_transform_cloud(transform: torch.Tensor, cloud: Cloud) -> Cloud:
    rot = transform[..., :3, :3]
    return Cloud(
        xyz=apply_transform(transform, cloud.xyz),
        rgb=cloud.rgb,
        valid=cloud.valid,
        # direction fields rotate without translating
        **map_optional(cloud, lambda v: rotate_points(rot, v)),
    )
