"""Headless point-cloud renderer with the reference viewer's camera (port
of ``rspc_tpu/viz/render.py``).

The reference draws with immediate-mode OpenGL in a GLFW window
(src/visualizer.hpp:55-103): ``gluPerspective(60, w/h, 0.01, 10)``,
``gluLookAt(0,0,0 -> 0,0,1, up -y)``, then the interactive state applied as
``T(0,0,0.5 + offset_y*0.05) Rx(pitch) Ry(yaw) T(0,0,-0.5)``, point size
``width/640``, per-point ``glColor3f(b,g,r)`` skipping z==0 points, clear
colour (153,153,153).

This module replays the same transform chain as a scatter rasterizer with
a z-buffer, on the device of the cloud: a ``scatter_reduce(..., "amin")``
of the depths over every point-size offset, then the colour of the point
that holds the pixel's minimum depth. Where several points hold it (at
any offset), the lowest point index wins (a second ``amin`` scatter,
over the point indices), so the image is the same on every device and
every run. The JAX package leaves that case to its scatter and to the
order of its offset passes, so its images may differ from these at such
pixels only.
The mouse state (yaw in [-120, 120], pitch in [-80, 80], scroll offsets,
space to reset; src/visualizer.hpp:24-53) lives in ``ViewState``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Union

import numpy as np
import torch

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud

BG = 153  # reference clear colour, 153/255 grey


@dataclasses.dataclass
class ViewState:
    """Mirror of the reference's ``state`` struct + callback clamping."""

    yaw: float = 0.0
    pitch: float = 0.0
    offset_x: float = 0.0
    offset_y: float = 0.0

    def drag(self, dx: float, dy: float) -> None:
        self.yaw = min(max(self.yaw - dx, -120.0), 120.0)
        self.pitch = min(max(self.pitch + dy, -80.0), 80.0)

    def scroll(self, xoff: float, yoff: float) -> None:
        self.offset_x += xoff
        self.offset_y += yoff

    def reset(self) -> None:
        self.yaw = self.pitch = 0.0
        self.offset_x = self.offset_y = 0.0


def _rotate(p: torch.Tensor, r: np.ndarray) -> torch.Tensor:
    """``p @ r.T`` as per-component products with f32 constants, so the
    CPU and the card round alike."""
    return torch.stack(
        [p[:, 0] * float(r[i, 0]) + p[:, 1] * float(r[i, 1]) + p[:, 2] * float(r[i, 2])
         for i in range(3)],
        dim=-1,
    )


def render_cloud(
    xyz: torch.Tensor,
    rgb: torch.Tensor,
    valid: torch.Tensor,
    yaw: float = 0.0,
    pitch: float = 0.0,
    offset_y: float = 0.0,
    width: int = 1280,
    height: int = 720,
    bgr_stored: bool = False,
) -> torch.Tensor:
    """Rasterize ``xyz f32[N,3]`` / ``rgb f32[N,3]`` / ``valid bool[N]``
    to ``u8[height, width, 3]`` on their device.

    ``bgr_stored=True`` replays the reference's glColor3f(b, g, r) channel
    swap (its clouds carry camera-BGR bytes; ours are RGB, so the default
    renders channels as-is)."""
    dev = xyz.device
    deg = np.float32(np.pi / 180.0)
    cy, sy = np.cos(np.float32(yaw) * deg), np.sin(np.float32(yaw) * deg)
    cp, sp = np.cos(np.float32(pitch) * deg), np.sin(np.float32(pitch) * deg)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)

    shift = torch.tensor([0.0, 0.0, -0.5], dtype=xyz.dtype, device=dev)
    p = _rotate(_rotate(xyz + shift, ry), rx)                  # Ry(yaw), Rx(pitch)
    z_off = float(np.float32(0.5) + np.float32(offset_y) * np.float32(0.05))
    # T(0,0,.5+off), then gluLookAt (negates y and z)
    x_eye, y_eye, z_eye = p[:, 0], -p[:, 1], -(p[:, 2] + z_off)

    # gluPerspective(60, aspect, .01, 10): f = cot(30 deg)
    f = 1.0 / math.tan(math.radians(60.0) / 2.0)
    aspect = width / height
    behind = z_eye >= -0.01  # GL camera looks down -z; clip near
    far_clip = z_eye < -10.0
    zsafe = torch.where(behind, torch.full_like(z_eye, -1.0), z_eye)
    x_ndc = (f / aspect) * x_eye / (-zsafe)
    y_ndc = f * y_eye / (-zsafe)

    px = ((x_ndc + 1.0) * 0.5 * width).to(torch.int32)
    py = ((1.0 - (y_ndc + 1.0) * 0.5) * height).to(torch.int32)

    # reference skips z==0 points (visualizer.hpp:86)
    ok = (
        valid
        & (xyz[:, 2] != 0.0)
        & ~behind
        & ~far_clip
        & (px >= 0)
        & (px < width)
        & (py >= 0)
        & (py < height)
    )

    col = rgb.flip(-1) if bgr_stored else rgb
    return rasterize(px, py, ok, -z_eye, col, width, height)


def rasterize(px, py, ok, depth, col, width: int, height: int) -> torch.Tensor:
    """Scatter the points ``ok`` at integer pixels ``(px, py)`` with
    ``depth`` (smaller is nearer) and colour ``col f32[N,3]`` into a
    ``u8[height, width, 3]`` image with a z-buffer, each point
    ``width // 640`` pixels square. At a pixel's minimum depth the lowest
    point index wins."""
    dev = depth.device
    hw = width * height
    # slot hw is the drop slot for points off the image
    flat = torch.where(ok, py.long() * width + px.long(), torch.full_like(px, hw, dtype=torch.long))
    point_size = max(int(width) // 640, 1)

    big = torch.finfo(depth.dtype).max
    order = torch.arange(depth.shape[0], device=dev)
    none = depth.shape[0]

    masked_depth = torch.where(ok, depth, torch.full_like(depth, big))
    offsets = [dy * width + dx for dy in range(point_size) for dx in range(point_size)]

    # pass 1: min depth per pixel over every point-size offset
    zbuf = torch.full((hw + 1,), big, dtype=depth.dtype, device=dev)
    for off in offsets:
        zbuf = zbuf.scatter_reduce(0, (flat + off).clamp(0, hw), masked_depth, "amin")
    # pass 2: the lowest index among the points at the min depth owns the pixel
    owner = torch.full((hw + 1,), none, dtype=torch.long, device=dev)
    for off in offsets:
        idx = (flat + off).clamp(0, hw)
        winner = ok & (depth <= zbuf[idx.clamp(max=hw - 1)])
        owner = owner.scatter_reduce(0, torch.where(winner, idx, torch.full_like(idx, hw)),
                                     order, "amin")
    img = torch.where((owner < none)[:, None], col[owner.clamp(max=max(none - 1, 0))],
                      torch.full((), float(BG), dtype=depth.dtype, device=dev))

    out = img[:hw].reshape(height, width, 3)
    return out.clamp(0, 255).to(torch.uint8)


def render_to_png(
    path: str,
    clouds: Union[Cloud, OrganizedCloud, Sequence],
    state: ViewState | None = None,
    width: int = 1280,
    height: int = 720,
) -> np.ndarray:
    """Render one or more clouds with the reference's default view on
    their device and save a PNG (the headless stand-in for the GLFW window
    loop, src/main.cpp:96-114). Returns the image as a host array."""
    from rspc_tpu_torch.viz.png import write_png

    if isinstance(clouds, (Cloud, OrganizedCloud)):
        clouds = [clouds]
    flat = [c.flatten() if isinstance(c, OrganizedCloud) else c for c in clouds]
    st = state or ViewState()
    img = render_cloud(
        torch.cat([c.xyz for c in flat], dim=0),
        torch.cat([c.rgb for c in flat], dim=0),
        torch.cat([c.valid for c in flat], dim=0),
        yaw=st.yaw,
        pitch=st.pitch,
        offset_y=st.offset_y,
        width=width,
        height=height,
    )
    img_np = img.cpu().numpy()
    write_png(path, img_np)
    return img_np
