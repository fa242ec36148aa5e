"""IMU complementary-filter rotation estimation (port of
``rspc_tpu/estimators/rotation.py``, after the reference's
``RotationEstimator``, src/rotation_estimator.hpp): gyro integration
blended with the accelerometer's tilt, alpha = 0.98, in f32.

The JAX ``lax.scan`` over the event stream becomes a Python loop over
the samples; each step computes both the gyro and the accel update and
selects one by the sample's kind on the device (no host sync per step).

Semantics kept exactly:
  * gyro: the FIRST samples (before any accel) only record their
    timestamp; later ones integrate ``theta += (-gz*dt, -gy*dt, +gx*dt)``
    with ``dt = (ts - last_ts) / 1000`` (millisecond stamps, seconds);
  * accel: ``angle.z = atan2(ay, az)``, ``angle.x = atan2(ax,
    sqrt(ay^2 + az^2))``; the first accel sample sets ``theta = (angle.x,
    PI, angle.z)`` (y = PI by the reference's convention) and clears the
    shared ``first`` flag; later samples blend x and z only:
    ``theta.{x,z} = alpha*theta.{x,z} + (1-alpha)*angle.{x,z}``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

GYRO = 0
ACCEL = 1


@dataclasses.dataclass(frozen=True)
class ImuSample:
    """IMU events: kind (0 = gyro, 1 = accel), xyz reading, timestamp [ms]."""

    kind: torch.Tensor  # i32[...]
    data: torch.Tensor  # f32[..., 3]
    ts: torch.Tensor    # f32[...], milliseconds

    @staticmethod
    def stream(kinds, data, ts, device="cuda") -> "ImuSample":
        """A stream from host values, on ``device`` (the card unless the
        caller names the CPU)."""
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        return ImuSample(t(kinds, torch.int32), t(data, torch.float32),
                         t(ts, torch.float32))

    def __len__(self) -> int:
        return self.kind.shape[0]

    def __getitem__(self, i) -> "ImuSample":
        return ImuSample(self.kind[i], self.data[i], self.ts[i])


@dataclasses.dataclass(frozen=True)
class FilterState:
    theta: torch.Tensor         # f32[3]
    first: torch.Tensor         # bool: true until the first accel sample
    last_ts_gyro: torch.Tensor  # f32, ms
    has_gyro_ts: torch.Tensor   # bool: a gyro timestamp has been recorded


def init_state(device="cuda", dtype=torch.float32) -> FilterState:
    return FilterState(
        theta=torch.zeros(3, dtype=dtype, device=device),
        first=torch.ones((), dtype=torch.bool, device=device),
        last_ts_gyro=torch.zeros((), dtype=dtype, device=device),
        has_gyro_ts=torch.zeros((), dtype=torch.bool, device=device),
    )


def _gyro_step(state: FilterState, data, ts) -> FilterState:
    dt = (ts - state.last_ts_gyro) / 1000.0
    delta = torch.stack([-data[2] * dt, -data[1] * dt, data[0] * dt])
    # while ``first``, process_gyro only records the timestamp
    theta = torch.where(state.first, state.theta, state.theta + delta)
    return FilterState(theta, state.first, ts, torch.ones_like(state.has_gyro_ts))


def _accel_step(state: FilterState, data, alpha) -> FilterState:
    angle_z = torch.atan2(data[1], data[2])
    angle_x = torch.atan2(data[0], torch.sqrt(data[1] * data[1] + data[2] * data[2]))
    init_theta = torch.stack([angle_x, torch.full_like(angle_x, math.pi), angle_z])
    blended = torch.stack([
        state.theta[0] * alpha + angle_x * (1.0 - alpha),
        state.theta[1],
        state.theta[2] * alpha + angle_z * (1.0 - alpha),
    ])
    theta = torch.where(state.first, init_theta, blended)
    return FilterState(theta, torch.zeros_like(state.first), state.last_ts_gyro,
                       state.has_gyro_ts)


def step(state: FilterState, sample: ImuSample, alpha: float = 0.98) -> FilterState:
    """Process one IMU event: both updates, one selected by its kind."""
    a = torch.tensor(alpha, dtype=sample.data.dtype, device=sample.data.device)
    g = _gyro_step(state, sample.data, sample.ts)
    acc = _accel_step(state, sample.data, a)
    is_gyro = sample.kind == GYRO
    return FilterState(*(
        torch.where(is_gyro, getattr(g, f.name), getattr(acc, f.name))
        for f in dataclasses.fields(FilterState)
    ))


def rotation_from_imu_stream(samples: ImuSample, alpha: float = 0.98,
                             snapshot_mask=None):
    """Run the filter over a ``[T]`` event stream. Returns ``(final theta
    f32[3], theta after every step f32[T, 3])``; with ``snapshot_mask``
    (bool ``[T]``) only the rows it marks, as the capture loop snapshots
    ``get_theta()`` after each frameset's gyro + accel pair
    (src/capture.hpp:160-166)."""
    state = init_state(samples.data.device, samples.data.dtype)
    thetas = []
    for i in range(len(samples)):
        state = step(state, samples[i], alpha)
        thetas.append(state.theta)
    all_thetas = torch.stack(thetas)
    if snapshot_mask is not None:
        mask = torch.as_tensor(np.asarray(snapshot_mask), device=all_thetas.device)
        return state.theta, all_thetas[mask]
    return state.theta, all_thetas


class RotationEstimator:
    """Stateful wrapper with the reference class's API (``process_gyro``,
    ``process_accel``, ``get_theta``), for a capture loop that feeds one
    frameset at a time; its state lives on ``device``."""

    def __init__(self, alpha: float = 0.98, device="cuda"):
        self.alpha = alpha
        self.device = device
        self._state = init_state(device)

    def process_gyro(self, gyro_xyz, ts_ms: float) -> None:
        sample = ImuSample.stream(GYRO, np.asarray(gyro_xyz, np.float32), ts_ms,
                                  self.device)
        self._state = step(self._state, sample, self.alpha)

    def process_accel(self, accel_xyz) -> None:
        sample = ImuSample.stream(ACCEL, np.asarray(accel_xyz, np.float32), 0.0,
                                  self.device)
        self._state = step(self._state, sample, self.alpha)

    def get_theta(self) -> np.ndarray:
        return self._state.theta.cpu().numpy()
