"""Rigid 3-D transforms and the reference's initial-guess builders (port
of ``rspc_tpu/ops/transform.py``).

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


def make_rigid(rotation: torch.Tensor, translation: torch.Tensor | None = None) -> torch.Tensor:
    """Assemble ``[..., 4, 4]`` homogeneous transforms from ``R [..., 3, 3]``
    and ``t [..., 3]`` (zero when omitted)."""
    t = (torch.zeros(rotation.shape[:-1], dtype=rotation.dtype, device=rotation.device)
         if translation is None else translation)
    top = torch.cat([rotation, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rotation.dtype,
                          device=rotation.device).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Transform composition a o b (apply b first): ``a @ b``."""
    return a @ b


def imu_guess_full(theta: torch.Tensor) -> torch.Tensor:
    """The ICP-edge scheme's IMU guess, all three axes mapped
    (src/icp_edge_based_registration.hpp:86-92):
    ``R = Rz(theta.x) @ Ry(-theta.y) @ Rx(theta.z)``; ``theta [..., 3]``."""
    r = (
        rotation_matrix(theta[..., 0], 2)
        @ rotation_matrix(-theta[..., 1], 1)
        @ rotation_matrix(theta[..., 2], 0)
    )
    return make_rigid(r)


def imu_guess_y(theta: torch.Tensor) -> torch.Tensor:
    """The NDT-edge scheme's IMU guess: ``Ry(-theta.y)`` only
    (src/ndt_edge_based_registration.hpp:79-80), unlike the ICP scheme's."""
    return make_rigid(rotation_matrix(-theta[..., 1], 1))


def static_y_guess(acc_rads) -> torch.Tensor:
    """Static accumulated y-rotation guess (callers accumulate
    ``acc_rads += rads`` per frame before calling)."""
    return make_rigid(rotation_matrix(torch.as_tensor(acc_rads, dtype=torch.float32), 1))


def relative_thetas(thetas: torch.Tensor) -> torch.Tensor:
    """Rebase IMU thetas ``[n, 3]`` against frame 0: ``theta_i - theta_0``
    for i >= 1, while ``theta_0`` itself stays as it is (the reference
    mutates ``thetas[i] += -thetas[0]`` in place for i >= 1 only,
    src/icp_edge_based_registration.hpp:83-84)."""
    return torch.cat([thetas[:1], (thetas - thetas[:1])[1:]], dim=0)
