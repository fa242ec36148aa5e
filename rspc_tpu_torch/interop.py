"""Conversions between the JAX package's state (in numpy form) and the
port's, so both packages compute from identical inputs.

State here is clouds, NDT grids (and with them the compact cells the
dense sweep derives from a grid), configs, camera intrinsics and pose
lists (the system has no weights).
The numpy form of an ``rspc_tpu`` cloud is ``{"xyz", "rgb", "valid"}``
plus ``"normal"`` where carried, as ``np.asarray`` of each field gives
them; nothing here imports jax.

This module is the CPU parity harness, not an entry point: its
functions keep ``device="cpu"`` as their default, where the port's entry
points default to the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rspc_tpu_torch import config as _config
from rspc_tpu_torch.cloud import OPTIONAL_VEC_FIELDS, Cloud, OrganizedCloud
from rspc_tpu_torch.ops.deproject import Intrinsics
from rspc_tpu_torch.registration.ndt import NDTConfig, NDTGrid, ndt_grid_from_moments


def cloud_from_numpy(fields: dict, organized: bool = False, device="cpu"):
    """``{xyz, rgb, valid[, normal, cgrad]}`` numpy arrays -> ``Cloud``
    (``xyz`` [..., N, 3]) or, with ``organized``, ``OrganizedCloud``
    (``xyz`` [..., H, W, 3])."""
    t = lambda a: torch.from_numpy(np.array(a)).to(device)  # copies
    kw = {k: t(fields[k]) for k in ("xyz", "rgb", "valid")}
    for name in OPTIONAL_VEC_FIELDS:
        if fields.get(name) is not None:
            kw[name] = t(fields[name])
    return OrganizedCloud(**kw) if organized else Cloud(**kw)


def cloud_to_numpy(cloud) -> dict:
    """A port cloud -> its ``{xyz, rgb, valid[, normal, cgrad]}`` numpy form."""
    return {
        f.name: getattr(cloud, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(cloud)
        if getattr(cloud, f.name) is not None
    }


def ndt_grid_from_numpy(moments: np.ndarray, origin: np.ndarray,
                        config: NDTConfig, device="cpu") -> NDTGrid:
    """An ``rspc_tpu`` grid's raw ``moments`` f32[D^3, 13] and ``origin``
    i32[3] -> the port's finalized ``NDTGrid``."""
    return ndt_grid_from_moments(
        torch.from_numpy(np.array(moments, np.float32)).to(device),
        torch.from_numpy(np.array(origin, np.int32)).to(device),
        config,
    )


def intrinsics_from_dict(values: dict) -> Intrinsics:
    """``dataclasses.asdict`` of the JAX package's ``Intrinsics``
    (Brown-Conrady ``coeffs`` included) -> the port's."""
    return _build(Intrinsics, values)


def poses_from_numpy(poses, device="cpu") -> torch.Tensor:
    """A pose list (4x4 arrays, or one ``[n, 4, 4]`` array, such as the
    JAX package's ``total_transforms``) -> f32 ``[n, 4, 4]`` on ``device``."""
    return torch.from_numpy(np.array(poses, np.float32).reshape(-1, 4, 4)).to(device)


def _build(cls, values: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        default = f.default
        if dataclasses.is_dataclass(default):
            v = _build(type(default), v)
        elif (isinstance(default, tuple) and default
              and dataclasses.is_dataclass(default[0])):
            v = tuple(_build(type(default[0]), x) for x in v)
        elif isinstance(default, tuple):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def config_from_dict(values: dict, cls=None):
    """Rebuild the port's config from ``dataclasses.asdict`` of the JAX
    package's (``PipelineConfig`` by default, or any config class of
    ``rspc_tpu_torch.config`` named by ``cls``)."""
    return _build(cls or _config.PipelineConfig, values)
