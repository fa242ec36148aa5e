"""World-frame rendering: pose-transformed clouds and the trajectory
polyline (port of ``rspc_tpu/viz/trajectory.py``).

The headless counterpart of the reference's ``draw_pointcloud_wrt_world``
and ``quat2mat`` (src/utils.hpp:814-905): the cloud is drawn under a
world pose (a quaternion and a translation, or a matrix, times an
optional extrinsics matrix), the trajectory is a green line strip in
world coordinates that takes part in the same depth test, and the
camera replays the reference's GL sequence:

    glTranslatef(0, 0, -0.75 - offset_y*0.05)
    glRotated(pitch, 1, 0, 0)
    glRotated(yaw, 0, -1, 0)
    glTranslatef(0, 0, 0.5)
    [cloud only] glMultMatrixf(H_world_pose); glMultMatrixf(H_extrinsics)
    gluPerspective(60, w/h, 0.01, 10)

Camera frusta for a list of poses go beyond the reference. The points
are rasterized on the cloud's device by ``viz/render.py::rasterize``: at
a pixel's minimum depth the lowest point index wins (the cloud's points
come first, then the line strips).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from rspc_tpu_torch.cloud import OrganizedCloud
from rspc_tpu_torch.viz.render import _rotate, rasterize

TRAJ_COLOR = (0.0, 255.0, 0.0)   # reference: glColor3f(0, 1, 0)
FRUSTUM_COLOR = (255.0, 255.0, 0.0)

# The world frame follows the reference's T265 convention (y up, z
# backward: "rotated from depth to world frame: z => -z, y => -y",
# src/utils.hpp:842). Depth-camera clouds (+z forward) are brought into it
# by the pose; with no tracking pose, pass this flip as the pose.
DEPTH_TO_WORLD = np.diag(np.float32([1.0, -1.0, -1.0, 1.0]))


def quat2mat(q) -> np.ndarray:
    """Quaternion (x, y, z, w) -> 4x4 row-major homogeneous matrix (the
    reference's quat2mat, src/utils.hpp:814-821, fills the same rotation
    in GL column-major order)."""
    x, y, z, w = [float(v) for v in q]
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w, 0.0],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w, 0.0],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        np.float32,
    )


def _polyline_points(verts: np.ndarray, samples_per_seg: int = 64) -> np.ndarray:
    """A polyline densified into points (the rasterizer's
    GL_LINE_STRIP)."""
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    if len(verts) < 2:
        return verts
    t = np.linspace(0.0, 1.0, samples_per_seg, endpoint=False, dtype=np.float32)
    a = verts[:-1][:, None, :]
    b = verts[1:][:, None, :]
    pts = a + (b - a) * t[None, :, None]
    return np.concatenate([pts.reshape(-1, 3), verts[-1:]], axis=0)


def frustum_lines(pose: np.ndarray, scale: float = 0.15) -> np.ndarray:
    """Wireframe camera frustum vertices (5 lines as one polyline with
    retraced edges) for a 4x4 camera-to-world pose."""
    c = np.zeros(3, np.float32)
    z = scale
    s = scale * 0.6
    corners = np.array(
        [[-s, -s * 0.75, z], [s, -s * 0.75, z], [s, s * 0.75, z], [-s, s * 0.75, z]],
        np.float32,
    )
    path = np.stack(
        [c, corners[0], corners[1], c, corners[1], corners[2], c,
         corners[2], corners[3], c, corners[3], corners[0]]
    )
    r, t = pose[:3, :3].astype(np.float32), pose[:3, 3].astype(np.float32)
    return path @ r.T + t


def _apply_pose(xyz: torch.Tensor, pose: np.ndarray) -> torch.Tensor:
    """``xyz f32[N,3]`` under one 4x4 ``pose``, row by row as the JAX
    package's per-point product (R[i,0] x + R[i,1] y + R[i,2] z + t)."""
    r, t = pose[:3, :3], pose[:3, 3]
    p = torch.stack([float(r[i, 0]) * xyz[:, 0] + float(r[i, 1]) * xyz[:, 1]
                     + float(r[i, 2]) * xyz[:, 2] for i in range(3)], dim=-1)
    return p + torch.from_numpy(np.array(t, np.float32)).to(xyz.device)


def _render_world(xyz, rgb, valid, yaw: float, pitch: float, offset_y: float,
                  width: int, height: int) -> torch.Tensor:
    """World-frame ``xyz f32[N,3]`` through the world camera, rasterized
    to ``u8[height, width, 3]`` on the points' device."""
    deg = np.float32(np.pi / 180.0)
    cy, sy = np.cos(np.float32(yaw) * deg), np.sin(np.float32(yaw) * deg)
    cp, sp = np.cos(np.float32(pitch) * deg), np.sin(np.float32(pitch) * deg)

    p = xyz + torch.tensor([0.0, 0.0, 0.5], dtype=xyz.dtype, device=xyz.device)  # T(0,0,0.5)
    p = _rotate(p, np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]], np.float32))  # R(yaw, -y)
    p = _rotate(p, np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32))  # Rx(pitch)
    z_eye = p[:, 2] + float(np.float32(-0.75) - np.float32(offset_y) * np.float32(0.05))

    f = 1.0 / math.tan(math.radians(60.0) / 2.0)
    aspect = width / height
    behind = z_eye >= -0.01
    far_clip = z_eye < -10.0
    zsafe = torch.where(behind, -1.0, z_eye)
    x_ndc = (f / aspect) * p[:, 0] / (-zsafe)
    y_ndc = f * p[:, 1] / (-zsafe)
    px = ((x_ndc + 1.0) * 0.5 * width).to(torch.int32)
    py = ((1.0 - (y_ndc + 1.0) * 0.5) * height).to(torch.int32)
    ok = (valid & ~behind & ~far_clip
          & (px >= 0) & (px < width) & (py >= 0) & (py < height))
    return rasterize(px, py, ok, -z_eye, rgb, width, height)


def render_trajectory(
    cloud,
    trajectory,
    pose: np.ndarray | None = None,
    extrinsics: np.ndarray | None = None,
    frusta: Sequence[np.ndarray] = (),
    yaw: float = 15.0,
    pitch: float = 15.0,
    offset_y: float = 2.0,
    width: int = 1280,
    height: int = 720,
) -> np.ndarray:
    """Render ``cloud`` under ``pose @ extrinsics`` together with the
    world-frame ``trajectory`` polyline (and camera ``frusta``, 4x4
    camera-to-world poses) on the cloud's device; returns the image as a
    host array. The defaults are glfw_state's (yaw and pitch 15, offset
    2, src/utils.hpp:744).

    ``pose`` is a 4x4 matrix or an (x, y, z, w) quaternion and
    translation pair ``(quat, t)`` (the reference's rs2_pose path)."""
    if isinstance(cloud, OrganizedCloud):
        cloud = cloud.flatten()
    dev = cloud.xyz.device
    if pose is None:
        pose_m = np.eye(4, dtype=np.float32)
    elif isinstance(pose, tuple):
        pose_m = quat2mat(pose[0])
        pose_m[:3, 3] = np.asarray(pose[1], np.float32)
    else:
        pose_m = np.asarray(pose, np.float32)
    if extrinsics is not None:
        pose_m = pose_m @ np.asarray(extrinsics, np.float32)

    xyz, rgb, valid = [_apply_pose(cloud.xyz, pose_m)], [cloud.rgb], [cloud.valid]

    def add_line(verts, color):
        pts = _polyline_points(verts)
        if not len(pts):
            return
        xyz.append(torch.from_numpy(pts).to(dev))
        rgb.append(torch.tensor(color, dtype=torch.float32, device=dev).expand(len(pts), 3))
        valid.append(torch.ones(len(pts), dtype=torch.bool, device=dev))

    add_line(np.asarray(trajectory, np.float32), TRAJ_COLOR)
    for fpose in frusta:
        add_line(frustum_lines(np.asarray(fpose, np.float32)), FRUSTUM_COLOR)

    img = _render_world(torch.cat(xyz), torch.cat(rgb), torch.cat(valid),
                        yaw, pitch, offset_y, width, height)
    return img.cpu().numpy()


def trajectory_from_transforms(total_transforms) -> np.ndarray:
    """The camera path (world positions) from a chain's per-frame
    camera-to-frame-0 transforms: frame-i points map into frame 0 by
    T_i, so camera i's origin in frame-0 coordinates is T_i[:3, 3]; the
    path starts at frame 0's origin. Takes an array or a tensor."""
    if isinstance(total_transforms, torch.Tensor):
        total_transforms = total_transforms.detach().cpu().numpy()
    t = np.asarray(total_transforms, np.float32)
    if t.ndim == 2:
        t = t[None]
    return np.stack([np.zeros(3, np.float32)] + [m[:3, 3] for m in t])
