"""Replay capture source (port of ``rspc_tpu/capture/replay.py``):
recorded RGBD + IMU framesets through the reference's capture loop
(``get_clouds``, src/capture.hpp:134-198).

Recording format: ``.npz`` (or a mapping) with arrays
  depth   u16[T, H, W]        Z16 depth frames
  color   u8[T, H, W, 3]      color frames
  ts      f32[T]              frameset timestamps [ms]
  gyro    f32[T, 3]           gyro reading attached to each frameset
  accel   f32[T, 3]           accel reading attached to each frameset
  intr    f32[6]              width, height, fx, fy, ppx, ppy
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from rspc_tpu_torch.cloud import OrganizedCloud
from rspc_tpu_torch.config import CaptureConfig
from rspc_tpu_torch.estimators.rotation import RotationEstimator
from rspc_tpu_torch.ops.deproject import Intrinsics, rgbd_to_organized_cloud


class ReplaySource:
    """Iterates recorded framesets: (depth, color, gyro, accel, ts_ms)."""

    def __init__(self, path_or_arrays):
        if isinstance(path_or_arrays, (str, bytes)) or hasattr(path_or_arrays, "__fspath__"):
            data = np.load(path_or_arrays)
        else:
            data = path_or_arrays
        self.depth = np.asarray(data["depth"])
        self.color = np.asarray(data["color"])
        self.ts = np.asarray(data["ts"], np.float32)
        self.gyro = np.asarray(data["gyro"], np.float32)
        self.accel = np.asarray(data["accel"], np.float32)
        w, h, fx, fy, ppx, ppy = [float(x) for x in np.asarray(data["intr"])]
        self.intr = Intrinsics(int(w), int(h), fx, fy, ppx, ppy)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]]:
        for i in range(self.depth.shape[0]):
            yield self.depth[i], self.color[i], self.gyro[i], self.accel[i], float(self.ts[i])

    @staticmethod
    def save(path, depth, color, ts, gyro, accel, intr: Intrinsics) -> None:
        np.savez_compressed(
            path,
            depth=np.asarray(depth, np.uint16),
            color=np.asarray(color, np.uint8),
            ts=np.asarray(ts, np.float32),
            gyro=np.asarray(gyro, np.float32),
            accel=np.asarray(accel, np.float32),
            intr=np.asarray([intr.width, intr.height, intr.fx, intr.fy, intr.ppx, intr.ppy],
                            np.float32),
        )


def get_clouds(
    source: ReplaySource,
    nr_frames: int,
    config: CaptureConfig = CaptureConfig(),
    device="cuda",
) -> Tuple[List[OrganizedCloud], np.ndarray]:
    """The reference capture loop over a replay source: per frameset feed
    gyro then accel into the rotation filter and snapshot theta; keep one
    frameset per ``config.throttle_ns`` and stop after ``nr_frames``
    keeps; then deproject each kept frameset on ``device`` (the card
    unless the caller names the CPU), with the BGR swizzle and the 3/5
    center crop as ``config`` says. Returns the clouds and the kept
    thetas ``f32[n, 3]`` (host array); the filter runs on ``device``."""
    algo = RotationEstimator(device=device)
    kept, thetas = [], []
    last_keep_ns = None
    for depth, color, gyro, accel, ts in source:
        algo.process_gyro(gyro, ts)
        algo.process_accel(accel)
        theta = algo.get_theta()
        now_ns = ts * 1e6  # ms -> ns
        if last_keep_ns is not None and (now_ns - last_keep_ns) < config.throttle_ns:
            continue
        last_keep_ns = now_ns
        kept.append((depth, color))
        thetas.append(theta)
        if len(kept) >= nr_frames:
            break

    clouds = []
    for depth, color in kept:
        oc = rgbd_to_organized_cloud(
            torch.from_numpy(np.asarray(depth).astype(np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(color)).to(device),
            source.intr,
            depth_scale=config.depth_scale,
            bgr=config.bgr_color,
        )
        clouds.append(oc.center_crop_3_5() if config.center_crop else oc)
    return clouds, np.stack(thetas) if thetas else np.zeros((0, 3), np.float32)
