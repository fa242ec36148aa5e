"""Auxiliary renderers: IMU axes, pose readout, frame mosaics (the
port's copy of ``rspc_tpu/viz/overlays.py``).

Headless counterparts of the reference's GL helper library
(src/utils.hpp; SURVEY.md C13):
  * ``render_imu_axes``   — the imu_renderer's 3-D axes + motion vector
    drawing (utils.hpp:108-326), as a PNG-able image;
  * ``pose_text``         — the pose_renderer's textual pose readout
    (utils.hpp:328-367);
  * ``frames_mosaic``     — the window's frameset grid layout
    (``calc_grid``, utils.hpp:673-720): arrange equal-size frames into a
    near-square grid.

Host-side visualization utilities in numpy, not on the device path.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    xs = np.linspace(p0[0], p1[0], n).astype(int)
    ys = np.linspace(p0[1], p1[1], n).astype(int)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def render_imu_axes(theta, accel=None, size: int = 256) -> np.ndarray:
    """Draw rotated XYZ axes (red/green/blue) for the filter state
    ``theta`` plus an optional acceleration vector (yellow) — the
    information content of the reference's imu_renderer."""
    import torch

    from rspc_tpu_torch.ops.transform import rotation_matrix

    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    img = np.full((size, size, 3), 40, np.uint8)
    r = (
        rotation_matrix(f32(theta[0]), 2)
        @ rotation_matrix(f32(-theta[1]), 1)
        @ rotation_matrix(f32(theta[2]), 0)
    ).numpy()
    center = np.array([size / 2, size / 2])
    scale = size * 0.35

    def project(v):
        # simple orthographic: x right, y down, z shrinks
        return center + np.array([v[0], -v[1]]) * scale * (1.0 - 0.3 * v[2])

    colors = ([255, 80, 80], [80, 255, 80], [80, 80, 255])
    for axis in range(3):
        v = r[:, axis]
        _draw_line(img, center, project(v), colors[axis])
    if accel is not None:
        a = np.asarray(accel, float)
        a = a / max(np.linalg.norm(a), 1e-9)
        _draw_line(img, center, project(a), [255, 255, 80])
    return img


def pose_text(translation, rotation_theta, velocity=None) -> str:
    """Textual pose readout (pose_renderer equivalent)."""
    tx, ty, tz = [float(x) for x in translation]
    rx, ry, rz = [float(x) for x in rotation_theta]
    lines = [
        f"translation: {tx:+.3f} {ty:+.3f} {tz:+.3f} [m]",
        f"rotation:    {rx:+.3f} {ry:+.3f} {rz:+.3f} [rad]",
    ]
    if velocity is not None:
        vx, vy, vz = [float(x) for x in velocity]
        lines.append(f"velocity:    {vx:+.3f} {vy:+.3f} {vz:+.3f} [m/s]")
    return "\n".join(lines)


def calc_grid(count: int) -> tuple[int, int]:
    """Near-square grid for ``count`` tiles (utils.hpp calc_grid)."""
    cols = int(np.ceil(np.sqrt(count)))
    rows = int(np.ceil(count / cols))
    return rows, cols


def frames_mosaic(frames: Sequence[np.ndarray]) -> np.ndarray:
    """Arrange equal-size RGB frames into a near-square grid image (the
    window's frameset mosaic)."""
    frames = [np.asarray(f, np.uint8) for f in frames]
    h, w = frames[0].shape[:2]
    rows, cols = calc_grid(len(frames))
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, f in enumerate(frames):
        r, c = divmod(i, cols)
        canvas[r * h : (r + 1) * h, c * w : (c + 1) * w] = f
    return canvas


def video_frame_to_rgb(data: np.ndarray, fmt: str) -> np.ndarray:
    """Decode a raw video frame into RGB u8 — the ``texture.upload``
    format switch (src/utils.hpp:405-421) without the GL upload.

    Formats: ``rgb8`` u8[H,W,3]; ``rgba8`` u8[H,W,4] (alpha dropped,
    matching GL_RGB internal format); ``bgr8`` u8[H,W,3]; ``y8`` u8[H,W]
    replicated to grey; ``y10bpack`` u16[H,W] with 10 significant bits
    (GL_LUMINANCE/GL_UNSIGNED_SHORT path: top bits map to intensity)."""
    d = np.asarray(data)
    f = fmt.lower()
    if f == "rgb8":
        return d.astype(np.uint8)
    if f == "rgba8":
        return d[..., :3].astype(np.uint8)
    if f == "bgr8":
        return d[..., ::-1].astype(np.uint8)
    if f == "y8":
        return np.repeat(d.astype(np.uint8)[..., None], 3, axis=-1)
    if f == "y10bpack":
        g = (d.astype(np.uint32) >> 2).clip(0, 255).astype(np.uint8)
        return np.repeat(g[..., None], 3, axis=-1)
    raise ValueError(f"The requested format is not supported: {fmt!r}")


def adjust_ratio(rect_wh, frame_wh):
    """The reference rect::adjust_ratio (src/utils.hpp:70-82): fit a
    frame's aspect into a rect, centered. Returns (x_off, y_off, w, h)."""
    rw, rh = float(rect_wh[0]), float(rect_wh[1])
    fw, fh = float(frame_wh[0]), float(frame_wh[1])
    ratio = fw / fh
    w, h = rw, rh
    if rw / rh > ratio:
        w = rh * ratio
    else:
        h = rw / ratio
    return ((rw - w) / 2.0, (rh - h) / 2.0, w, h)


def show_in_rect(
    canvas: np.ndarray, frame_rgb: np.ndarray, rect, label: str = ""
) -> None:
    """Draw a frame into a canvas sub-rect with aspect-preserving fit
    (texture::show + rect::adjust_ratio). ``rect`` = (x, y, w, h) in
    canvas pixels; nearest-neighbor resample (GL_LINEAR's cheap cousin —
    the semantics under test are layout, not filtering)."""
    x, y, w, h = [float(v) for v in rect]
    fx, fy, fw, fh = adjust_ratio((w, h), (frame_rgb.shape[1], frame_rgb.shape[0]))
    x0, y0 = int(x + fx), int(y + fy)
    wi, hi = max(int(fw), 1), max(int(fh), 1)
    ys = (np.arange(hi) * frame_rgb.shape[0] / hi).astype(int)
    xs = (np.arange(wi) * frame_rgb.shape[1] / wi).astype(int)
    patch = frame_rgb[ys][:, xs]
    hcan, wcan = canvas.shape[:2]
    y1, x1 = min(y0 + hi, hcan), min(x0 + wi, wcan)
    if y1 > y0 and x1 > x0:
        canvas[y0:y1, x0:x1] = patch[: y1 - y0, : x1 - x0]


class KeyListener:
    """Mirror of the reference's ``window_key_listener``
    (src/utils.hpp:724-740): remembers the last released key; ``get_key``
    returns and clears it (-1 = none, GLFW_KEY_UNKNOWN)."""

    UNKNOWN = -1

    def __init__(self):
        self.last_key = self.UNKNOWN

    def on_key_release(self, key: int) -> None:
        self.last_key = key

    def get_key(self) -> int:
        key = self.last_key
        self.last_key = self.UNKNOWN
        return key
