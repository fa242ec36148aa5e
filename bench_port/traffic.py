"""The benchmark's one traffic generator: RGBD sweeps of a synthetic room,
rendered on the device from ``--seed``, as the parameters of a mix file
(``mixes/<traffic>.json``) and a configuration's camera ask.

A sweep is one user's capture: ``frames`` frames of a camera yawing in
place at the centre of a 6 m room with five boxes on the floor (the
scene of ``rspc_tpu_torch/capture/synthetic.py``, copied here so that
the inputs do not come from the program under test). Frame ``i`` of a
sweep with yaw step ``y`` looks along yaw ``i * y``. Depth is z-depth in
millimetres (the D435i's Z16), with optional RealSense-style axial noise
``sigma = a + b z^2`` drawn on the device.

Every seed gets the same work: a mix's ``pool`` sweeps take the yaw
steps ``linspace(yaw_lo, yaw_hi, pool)``; the seed only permutes them
over the pool and draws the noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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

# axis-aligned boxes standing on the floor ((min xyz), (max xyz), base RGB)
_BOXES = (
    ((2.2, 0.0, 4.2), (2.9, 1.4, 4.9), (240, 160, 40)),
    ((3.6, 0.0, 4.6), (4.3, 0.9, 5.3), (40, 160, 240)),
    ((2.8, 0.0, 5.0), (3.5, 1.9, 5.7), (160, 240, 120)),
    ((1.2, 0.0, 3.6), (1.7, 1.1, 4.1), (230, 90, 180)),
    ((4.4, 0.0, 3.4), (5.0, 0.7, 3.9), (120, 120, 250)),
)

SEED_MASK = 2**63 - 1


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole intrinsics of ``width`` x ``height`` at ``fov_deg``
    horizontal field of view, principal point at the centre."""

    width: int
    height: int
    fov_deg: float = 60.0
    depth_scale: float = 0.001

    @property
    def f(self) -> float:
        return self.width / (2.0 * np.tan(np.radians(self.fov_deg) / 2.0))


@dataclasses.dataclass(frozen=True)
class Sweep:
    """One sweep's inputs on the device: ``xyz f32[n, H, W, 3]``,
    ``rgb f32[n, H, W, 3]`` (0..255), ``valid bool[n, H, W]``, and its
    yaw step (rad per frame)."""

    xyz: torch.Tensor
    rgb: torch.Tensor
    valid: torch.Tensor
    yaw: float


def _texture(p: torch.Tensor, axis: int, base) -> torch.Tensor:
    """0.25 m checker + 1 m stripes over the two in-plane coordinates."""
    u, v = [p[..., i] for i in range(3) if i != axis]
    checker = (torch.floor(u / 0.25) + torch.floor(v / 0.25)) % 2.0
    stripe = (torch.floor(u / 1.0) % 2.0) * 0.5
    shade = 0.45 + 0.4 * checker + 0.15 * stripe
    return torch.tensor(base, dtype=torch.float32, device=p.device) * shade[..., None]


def _render(yaws: list[float], cam: Camera, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Ray-cast one frame per yaw from the room centre, all frames at
    once: (z-depth in metres f32[n, H, W], 0 where no surface; colour
    f32[n, H, W, 3]). Elementwise arithmetic only, so no matmul setting
    changes the frames."""
    h, w = cam.height, cam.width
    u = torch.arange(w, dtype=torch.float32, device=device).expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x, y = (u - w / 2.0) / cam.f, (v - h / 2.0) / cam.f
    c = torch.tensor(np.cos(yaws), dtype=torch.float32, device=device)[:, None, None]
    s = torch.tensor(np.sin(yaws), dtype=torch.float32, device=device)[:, None, None]
    # the camera ray (x, y, 1) turned by the yaw about the y axis
    d_w = torch.stack([c * x + s, y.expand(len(yaws), h, w), c - s * x], dim=-1)
    o = torch.tensor([ROOM / 2.0, 1.2, ROOM / 2.0], dtype=torch.float32, device=device)
    best_t = torch.full(d_w.shape[:-1], float("inf"), device=device)
    best_col = torch.zeros(d_w.shape, device=device)

    def consider(axis, offset, base, bounds):
        nonlocal best_t, best_col
        denom = d_w[..., axis]
        t = (offset - o[axis]) / torch.where(denom.abs() < 1e-6, 1e-6, denom)
        p = o + t[..., None] * d_w
        inside = torch.ones(t.shape, dtype=torch.bool, device=device)
        for i in range(3):
            if i != axis:
                lo, hi = bounds[i]
                inside &= (p[..., i] >= lo - 1e-3) & (p[..., i] <= hi + 1e-3)
        hit = (t > 0.05) & inside & (t < best_t)
        best_t = torch.where(hit, t, best_t)
        best_col = torch.where(hit[..., None], _texture(p, axis, base), best_col)

    for axis, offset, base in _WALLS:
        consider(axis, offset, base, ((0.0, ROOM),) * 3)
    for mn, mx, base in _BOXES:
        bounds = tuple((mn[i], mx[i]) for i in range(3))
        for axis in range(3):
            consider(axis, mn[axis], base, bounds)
            consider(axis, mx[axis], base, bounds)
    # the ray parameter along a direction whose camera z is 1 is z-depth
    depth = torch.where(torch.isfinite(best_t), best_t, 0.0)
    return depth, torch.clamp(best_col, 0, 255).floor()


def render_sweep(yaw: float, frames: int, cam: Camera, noise: dict, seed: int,
                 device) -> Sweep:
    """One sweep of ``frames`` deprojected frames at yaw step ``yaw``;
    the noise is drawn from ``seed`` on ``device``."""
    depth, color = _render([i * yaw for i in range(frames)], cam, device)
    a, b = float(noise.get("axial_a", 0.0)), float(noise.get("axial_b", 0.0))
    if a > 0.0 or b > 0.0:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed & SEED_MASK)
        z = torch.randn(depth.shape, generator=gen, device=device)
        depth = torch.where(depth > 0, depth + z * (a + b * depth * depth), 0.0)
    # Z16: whole millimetres, 0 where there is no return
    z = torch.clamp(torch.round(depth / cam.depth_scale), 0, 65535) * cam.depth_scale
    ok = z > 0
    h, w = cam.height, cam.width
    u = torch.arange(w, dtype=torch.float32, device=device).expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    rx = float(np.float32(1.0) / np.float32(cam.f))
    xyz = torch.stack([(u - w / 2.0) * rx * z, (v - h / 2.0) * rx * z, z], dim=-1)
    return Sweep(xyz, torch.where(ok[..., None], color, 0.0), ok, float(yaw))


def pool_yaws(mix: dict, seed: int) -> list[float]:
    """The yaw step of each of the mix's ``pool`` sweeps: the same set for
    every seed, in the seed's order."""
    lo, hi = mix["yaw_range"]
    yaws = np.linspace(lo, hi, int(mix["pool"]))
    return [float(y) for y in np.random.default_rng(seed).permutation(yaws)]


def make_pool(mix: dict, cam: Camera, seed: int, device, only=None) -> dict[int, Sweep]:
    """The mix's sweeps by pool index (``only``: those indices alone)."""
    yaws = pool_yaws(mix, seed)
    keep = range(len(yaws)) if only is None else sorted(set(only))
    return {j: render_sweep(yaws[j], int(mix["frames"]), cam, mix.get("noise", {}),
                            seed * 131 + j, device) for j in keep}
