"""Synthetic RGBD sequence generator (port of
``rspc_tpu/capture/synthetic.py``): a per-pixel ray caster against the six
walls of a textured room plus five floor-standing boxes, with a
procedural checker + stripe texture that gives the RGB Canny extractor
real edges. Depth is z-depth in Z16 millimetre units (depth_scale 0.001).

Frames render on the device the caller names (the card by default;
tests pass ``device="cpu"``), so the benchmark workload needs nothing
from the JAX package. The IMU stream and
``thetas()`` are not ported yet (ROADMAP.md Queue A).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rspc_tpu_torch.ops.deproject import (
    Intrinsics,
    pixel_grid,
    rgbd_to_organized_cloud,
)
from rspc_tpu_torch.ops.transform import rotation_matrix

ROOM = 6.0  # room edge length [m]

# (axis, offset, base RGB) for the six walls
_WALLS = (
    (0, 0.0, (200, 80, 80)),
    (0, ROOM, (80, 200, 80)),
    (1, 0.0, (80, 80, 200)),
    (1, ROOM, (200, 200, 80)),
    (2, 0.0, (200, 80, 200)),
    (2, ROOM, (80, 200, 200)),
)

# Axis-aligned boxes standing on the floor ((min xyz), (max xyz), base RGB)
_BOXES = (
    ((2.2, 0.0, 4.2), (2.9, 1.4, 4.9), (240, 160, 40)),
    ((3.6, 0.0, 4.6), (4.3, 0.9, 5.3), (40, 160, 240)),
    ((2.8, 0.0, 5.0), (3.5, 1.9, 5.7), (160, 240, 120)),
    ((1.2, 0.0, 3.6), (1.7, 1.1, 4.1), (230, 90, 180)),
    ((4.4, 0.0, 3.4), (5.0, 0.7, 3.9), (120, 120, 250)),
)


def _texture(p: torch.Tensor, axis: int, base) -> torch.Tensor:
    """0.25 m checker + 1 m stripes over the two in-plane coordinates."""
    u, v = [p[..., i] for i in range(3) if i != axis]
    checker = (torch.floor(u / 0.25) + torch.floor(v / 0.25)) % 2.0
    stripe = (torch.floor(u / 1.0) % 2.0) * 0.5
    shade = 0.45 + 0.4 * checker + 0.15 * stripe
    col = torch.tensor(base, dtype=torch.float32, device=p.device)
    return col[None, None, :] * shade[..., None]


def render_frame(pose_c2w: torch.Tensor, intr: Intrinsics):
    """Render ``(depth_z16 i32[H,W], color u8[H,W,3])`` from a
    camera-to-world pose inside the room, on ``pose_c2w``'s device.
    (Depth is returned as int32 holding the u16 Z16 values: PyTorch's
    uint16 support on CUDA is thin.)"""
    h, w = intr.height, intr.width
    dev = pose_c2w.device
    u, v = pixel_grid(h, w, dev)
    d_cam = torch.stack(
        [(u - intr.ppx) / intr.fx, (v - intr.ppy) / intr.fy,
         torch.ones((h, w), device=dev)],
        dim=-1,
    )
    r = pose_c2w[:3, :3]
    o = pose_c2w[:3, 3]
    d_w = d_cam @ r.T  # [H,W,3]

    best_t = torch.full((h, w), float("inf"), device=dev)
    best_col = torch.zeros((h, w, 3), device=dev)
    eps = 1e-6

    def consider(axis, offset, base, bounds):
        nonlocal best_t, best_col
        denom = d_w[..., axis]
        t = (offset - o[axis]) / torch.where(denom.abs() < eps, eps, denom)
        p = o[None, None, :] + t[..., None] * d_w
        inside = torch.ones((h, w), dtype=torch.bool, device=dev)
        for i in range(3):
            if i != axis:
                lo, hi = bounds[i]
                inside &= (p[..., i] >= lo - 1e-3) & (p[..., i] <= hi + 1e-3)
        hit = (t > 0.05) & inside & (t < best_t)
        best_t = torch.where(hit, t, best_t)
        best_col = torch.where(hit[..., None], _texture(p, axis, base), best_col)

    full = ((0.0, ROOM),) * 3
    for axis, offset, base in _WALLS:
        consider(axis, offset, base, full)
    for mn, mx, base in _BOXES:
        bounds = tuple((mn[i], mx[i]) for i in range(3))
        for axis in range(3):
            consider(axis, mn[axis], base, bounds)
            consider(axis, mx[axis], base, bounds)

    depth_m = torch.where(torch.isfinite(best_t), best_t, 0.0)
    # round-to-nearest millimetre (half to even, as jnp.round)
    depth_z16 = torch.clamp(torch.round(depth_m * 1000.0), 0, 65535).to(torch.int32)
    color = torch.clamp(best_col, 0, 255).to(torch.uint8)
    return depth_z16, color


@dataclasses.dataclass(frozen=True)
class DepthNoise:
    """RealSense-style depth sensor noise, applied host-side with numpy
    exactly as the JAX package does (same rng draws, bit for bit)."""

    axial_a: float = 0.001
    axial_b: float = 0.0019
    lateral_px: float = 0.0
    dropout: float = 0.0

    def apply(self, depth_z16: np.ndarray, rng: np.random.Generator):
        d = depth_z16.astype(np.float32) * 1e-3  # meters
        h, w = d.shape
        if self.lateral_px > 0:
            vv, uu = np.meshgrid(
                np.arange(h, dtype=np.float32),
                np.arange(w, dtype=np.float32),
                indexing="ij",
            )
            ju = np.clip(
                np.rint(uu + rng.normal(0, self.lateral_px, d.shape)), 0, w - 1
            ).astype(np.int64)
            jv = np.clip(
                np.rint(vv + rng.normal(0, self.lateral_px, d.shape)), 0, h - 1
            ).astype(np.int64)
            d = d[jv, ju]
        valid = d > 0
        if self.axial_a > 0 or self.axial_b > 0:
            sigma = self.axial_a + self.axial_b * d * d
            d = np.where(valid, d + rng.normal(0, 1, d.shape) * sigma, 0.0)
        if self.dropout > 0:
            d = np.where(rng.random(d.shape) < self.dropout, 0.0, d)
        return np.clip(np.rint(d * 1000.0), 0, 65535).astype(np.uint16)


@dataclasses.dataclass
class SyntheticSequence:
    """A camera yawing in place at the room centre: frame i pose =
    base @ Ry(yaw_i), optionally translating per frame. Same knobs and
    poses as the JAX package's sequence; ground truth maps frame-i points
    into frame-0 coordinates."""

    n_frames: int = 4
    yaw_step: float = -0.2
    intr: Intrinsics = Intrinsics.simple(160, 120)
    seed: int = 0
    noise: DepthNoise | None = None
    texture_contrast: float = 1.0
    translation_step: tuple = (0.0, 0.0, 0.0)
    yaw_schedule: tuple | None = None
    translation_schedule: tuple | None = None

    def __post_init__(self):
        c = ROOM / 2.0
        base = np.eye(4, dtype=np.float32)
        base[:3, 3] = [c, 1.2, c]  # tripod-height camera
        if self.yaw_schedule is not None:
            if len(self.yaw_schedule) != self.n_frames:
                raise ValueError(
                    f"yaw_schedule needs {self.n_frames} entries, got "
                    f"{len(self.yaw_schedule)}"
                )
            self.yaws = [float(y) for y in self.yaw_schedule]
        else:
            self.yaws = [i * self.yaw_step for i in range(self.n_frames)]
        step = np.asarray(self.translation_step, np.float32)
        if self.translation_schedule is not None:
            if len(self.translation_schedule) != self.n_frames:
                raise ValueError(
                    f"translation_schedule needs {self.n_frames} entries"
                )
            offsets = [np.asarray(t, np.float32) for t in self.translation_schedule]
        else:
            offsets = [i * step for i in range(self.n_frames)]
        self.poses = []
        for i, yaw in enumerate(self.yaws):
            ry = rotation_matrix(torch.tensor(yaw, dtype=torch.float32), 1).numpy()
            p = base.copy()
            p[:3, :3] = base[:3, :3] @ ry
            p[:3, 3] = base[:3, 3] + offsets[i]
            self.poses.append(p)

    def gt_transform(self, i: int) -> np.ndarray:
        """Maps frame-i camera coords into frame-0 camera coords."""
        return np.linalg.inv(self.poses[0]) @ self.poses[i]

    def frames(self, device="cuda"):
        """``(depth_z16, color)`` per frame, rendered on ``device``."""
        for i, p in enumerate(self.poses):
            depth, color = render_frame(torch.from_numpy(p).to(device), self.intr)
            if self.texture_contrast != 1.0:
                c = color.cpu().numpy().astype(np.float32)
                mean = c.mean(axis=(0, 1), keepdims=True)
                c = mean + self.texture_contrast * (c - mean)
                color = torch.from_numpy(np.clip(c, 0, 255).astype(np.uint8)).to(device)
            if self.noise is not None:
                rng = np.random.default_rng(self.seed * 1000 + i)
                noisy = self.noise.apply(depth.cpu().numpy().astype(np.uint16), rng)
                depth = torch.from_numpy(noisy.astype(np.int32)).to(device)
            yield depth, color

    def clouds(self, device="cuda", bgr: bool = False):
        """The deprojected ``OrganizedCloud`` of every frame, on ``device``."""
        return [
            rgbd_to_organized_cloud(depth, color, self.intr, bgr=bgr)
            for depth, color in self.frames(device)
        ]
