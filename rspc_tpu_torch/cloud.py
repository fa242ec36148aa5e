"""Core point-cloud containers as frozen dataclasses of tensors.

Port of ``rspc_tpu/cloud.py``: clouds are **fixed-capacity padded
tensors** with an explicit validity mask, so every output compares
element by element with the JAX package's.

  * ``Cloud``          -- unorganized: ``xyz f32[N,3]``, ``rgb f32[N,3]``
                         (0..255), ``valid bool[N]``; the live point count
                         is ``valid.sum()``.
  * ``OrganizedCloud`` -- image-shaped: ``xyz f32[H,W,3]``,
                         ``rgb f32[H,W,3]``, ``valid bool[H,W]``.

Both may carry leading batch dimensions (a stacked sequence of frames);
``map`` applies one function to every tensor field, which replaces
``jax.tree.map`` over the JAX pytrees.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

# Optional per-point [.., 3] vector payloads beyond xyz/rgb.
OPTIONAL_VEC_FIELDS = ("normal", "cgrad")


def map_optional(cloud, fn) -> dict:
    """Apply ``fn`` to each non-None optional vector field; returns the
    kwargs dict (absent fields stay None)."""
    return {
        name: (None if getattr(cloud, name) is None else fn(getattr(cloud, name)))
        for name in OPTIONAL_VEC_FIELDS
    }


class _TensorFields:
    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """New cloud of the same class with ``fn`` applied to every
        tensor field (None fields stay None)."""
        return type(self)(
            **{
                f.name: (None if getattr(self, f.name) is None
                         else fn(getattr(self, f.name)))
                for f in dataclasses.fields(self)
            }
        )

    @property
    def device(self) -> torch.device:
        return self.xyz.device


@dataclasses.dataclass(frozen=True)
class Cloud(_TensorFields):
    """Unorganized colored point cloud with a validity mask."""

    xyz: torch.Tensor    # f32[N, 3]
    rgb: torch.Tensor    # f32[N, 3], 0..255
    valid: torch.Tensor  # bool[N]
    normal: Optional[torch.Tensor] = None  # f32[N, 3] or None
    cgrad: Optional[torch.Tensor] = None   # f32[N, 3] or None

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        """Live point count (int32 tensor, no host sync)."""
        return self.valid.sum(dim=-1, dtype=torch.int32)

    @staticmethod
    def empty(
        capacity: int,
        device,
        dtype=torch.float32,
        with_normal: bool = False,
        with_cgrad: bool = False,
    ) -> "Cloud":
        z = lambda: torch.zeros((capacity, 3), dtype=dtype, device=device)
        return Cloud(
            xyz=z(),
            rgb=z(),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            normal=z() if with_normal else None,
            cgrad=z() if with_cgrad else None,
        )

    @staticmethod
    def from_numpy(
        xyz: np.ndarray,
        rgb: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        valid: Optional[np.ndarray] = None,
        device="cuda",
    ) -> "Cloud":
        """Padded Cloud from host arrays, on ``device`` (the card unless
        the caller names the CPU); without ``valid``, non-finite or
        z == 0 points are invalid (same rule as the JAX package)."""
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        n = xyz.shape[0]
        if rgb is None:
            rgb = np.zeros((n, 3), np.float32)
        rgb = np.asarray(rgb, np.float32).reshape(-1, 3)
        if valid is None:
            valid = np.isfinite(xyz).all(axis=-1) & (xyz[:, 2] != 0.0)
        valid = np.asarray(valid, bool).reshape(-1)
        cap = capacity if capacity is not None else n
        if n > cap:
            raise ValueError(f"{n} points exceed capacity {cap}")
        pad = cap - n
        xyz = np.pad(np.nan_to_num(xyz), ((0, pad), (0, 0)))
        rgb = np.pad(rgb, ((0, pad), (0, 0)))
        valid = np.pad(valid, (0, pad))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return Cloud(t(xyz), t(rgb), t(valid))

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """(xyz, rgb) of only the valid points, as host arrays."""
        valid = self.valid.cpu().numpy()
        return self.xyz.cpu().numpy()[valid], self.rgb.cpu().numpy()[valid]

    def pad_to(self, capacity: int) -> "Cloud":
        """Grow capacity (no-op if already at least ``capacity``)."""
        pad = capacity - self.capacity
        if pad <= 0:
            return self
        grow = lambda x: torch.nn.functional.pad(x, (0, 0, 0, pad))
        return Cloud(
            xyz=grow(self.xyz),
            rgb=grow(self.rgb),
            valid=torch.nn.functional.pad(self.valid, (0, pad)),
            **map_optional(self, grow),
        )


@dataclasses.dataclass(frozen=True)
class OrganizedCloud(_TensorFields):
    """Image-shaped (organized) colored point cloud."""

    xyz: torch.Tensor    # f32[H, W, 3]
    rgb: torch.Tensor    # f32[H, W, 3], 0..255
    valid: torch.Tensor  # bool[H, W]
    normal: Optional[torch.Tensor] = None
    cgrad: Optional[torch.Tensor] = None

    @property
    def height(self) -> int:
        return self.xyz.shape[-3]

    @property
    def width(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=(-1, -2), dtype=torch.int32)

    def flatten(self) -> Cloud:
        """Row-major flatten to an unorganized Cloud (capacity = H*W)."""
        lead = self.xyz.shape[:-3]
        hw = self.height * self.width
        return Cloud(
            xyz=self.xyz.reshape(*lead, hw, 3),
            rgb=self.rgb.reshape(*lead, hw, 3),
            valid=self.valid.reshape(*lead, hw),
            **map_optional(self, lambda x: x.reshape(*lead, hw, 3)),
        )

    def center_crop_3_5(self) -> "OrganizedCloud":
        """The middle 3/5 x 3/5 of the image, rows [H/5, 4H/5) x columns
        [W/5, 4W/5), the reference's crop (src/blur_filter.hpp:18-36,
        src/capture.hpp:79-88). H and W must be multiples of 5, where the
        reference's resize and copy agree (640x480, 1280x720); leading
        batch dimensions are kept."""
        h, w = self.height, self.width
        if h % 5 or w % 5:
            raise ValueError("center_crop_3_5 requires H, W divisible by 5")
        r0, r1, c0, c1 = h // 5, (h // 5) * 4, w // 5, (w // 5) * 4
        img = lambda x: x[..., r0:r1, c0:c1, :]
        return OrganizedCloud(
            xyz=img(self.xyz),
            rgb=img(self.rgb),
            valid=self.valid[..., r0:r1, c0:c1],
            **map_optional(self, img),
        )

    @staticmethod
    def from_numpy(
        xyz: np.ndarray,
        rgb: Optional[np.ndarray] = None,
        valid: Optional[np.ndarray] = None,
        device="cuda",
    ) -> "OrganizedCloud":
        """Organized cloud from host ``[H, W, 3]`` arrays, on ``device``
        (the card unless the caller names the CPU)."""
        xyz = np.asarray(xyz, np.float32)
        if xyz.ndim != 3 or xyz.shape[-1] != 3:
            raise ValueError(f"xyz must be [H,W,3], got {xyz.shape}")
        h, w, _ = xyz.shape
        if rgb is None:
            rgb = np.zeros((h, w, 3), np.float32)
        rgb = np.asarray(rgb, np.float32)
        if valid is None:
            valid = np.isfinite(xyz).all(axis=-1) & (xyz[..., 2] != 0.0)
        valid = np.asarray(valid, bool)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return OrganizedCloud(t(np.nan_to_num(xyz)), t(rgb), t(valid))


def concatenate(a: Cloud, b: Cloud) -> Cloud:
    """``b``'s points after ``a``'s (PCL ``operator+`` on clouds), the
    capacity the sum, compacted so that the valid points lead; an
    optional field survives when both clouds carry it."""
    cat = lambda name: torch.cat([getattr(a, name), getattr(b, name)], dim=0)
    opt = {name: cat(name) for name in OPTIONAL_VEC_FIELDS
           if getattr(a, name) is not None and getattr(b, name) is not None}
    return compact(Cloud(cat("xyz"), cat("rgb"), cat("valid"), **opt))


def compact(c: Cloud, capacity: Optional[int] = None) -> Cloud:
    """Stable-compact valid points to the front (static output capacity);
    the port of ``rspc_tpu.cloud.compact``."""
    cap = capacity if capacity is not None else c.capacity
    order = torch.argsort((~c.valid).to(torch.uint8), stable=True)
    if cap <= c.capacity:
        order = order[:cap]
    take = lambda x: x.index_select(0, order)
    out = Cloud(take(c.xyz), take(c.rgb), take(c.valid), **map_optional(c, take))
    return out.pad_to(cap)
