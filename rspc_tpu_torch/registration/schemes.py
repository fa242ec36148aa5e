"""Registration schemes (port of ``rspc_tpu/registration/schemes.py``):

  * ``NDTEdgeBasedRegistration`` -- NDT coarse + ICP fine on RGB-edge
    clouds, chained incrementally over a frame sequence, with the static
    per-frame yaw guesses -- on the fused path;
  * ``IncrementalICP`` -- guess-free ICP of each full cloud against the
    accumulated target (both the scan path and the ``use_scan=False``
    loop path).

Not ported yet (ROADMAP.md Queue A): IMU guesses (``thetas``), the
edge schemes' per-frame loop path (``use_scan=False``) and
``ICPEdgeBasedRegistration``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud
from rspc_tpu_torch.config import PipelineConfig
from rspc_tpu_torch.ops.transform import apply_transform_cloud
from rspc_tpu_torch.ops.voxel import voxel_downsample
from rspc_tpu_torch.registration.bufferops import (
    _as_unorganized,
    _block_append,
    merge_append,
)
from rspc_tpu_torch.registration.chainscan import _registration_fused, _stack
from rspc_tpu_torch.registration.icp import ICPResult, icp_align


class RegistrationScheme:
    """Abstract base (reference: src/types.hpp:14-20)."""

    def registration(self, clouds: Sequence) -> Cloud:
        raise NotImplementedError


class NDTEdgeBasedRegistration(RegistrationScheme):
    """NDT coarse + ICP refine on edge clouds
    (src/ndt_edge_based_registration.hpp), on the fused path."""

    def __init__(
        self,
        thetas: Optional[np.ndarray] = None,
        rads: Optional[float] = None,
        config: PipelineConfig = PipelineConfig(),
    ):
        if thetas is not None:
            raise NotImplementedError(
                "IMU guesses are not ported yet (ROADMAP.md Queue A)"
            )
        self.config = config
        self.rads = float(rads) if rads is not None else config.default_rads
        self.total_transforms = None  # [n-1,4,4] composed per-frame transforms
        self.anchor_accepted = None
        self._out = None

    def registration(self, clouds: Sequence[OrganizedCloud]) -> Cloud:
        """Register organized frames of one shape (on any one device);
        returns the global cloud. Frame i's transform into frame 0 is
        ``total_transforms[i - 1]``."""
        cfg = self.config
        if not cfg.use_scan:
            raise NotImplementedError(
                "the per-frame loop path is not ported yet (ROADMAP.md Queue A)"
            )
        if (len(clouds) < 2
                or not all(isinstance(c, OrganizedCloud) for c in clouds)
                or len({(c.height, c.width) for c in clouds}) != 1):
            raise ValueError(
                "registration needs >= 2 organized clouds of one shape"
            )
        n = len(clouds)
        stacked = _stack([OrganizedCloud(c.xyz, c.rgb, c.valid) for c in clouds])
        out = _registration_fused(
            stacked, list(clouds), self._guesses(n, stacked.device), cfg.edge,
            cfg.ndt, cfg.icp, cfg.refine, cfg.voxel.leaf_size,
            cfg.voxel.max_points, cfg.coarse_guard_cap,
        )
        self._out = out
        self.total_transforms = out["totals"]
        self.anchor_accepted = out["anchor_accepted"]
        return out["global"]

    @property
    def results(self):
        """[(coarse, fine)] per registered pair, PCL-parity result
        bundles (``NDTResult``, ``ICPResult``)."""
        if self._out is None:
            return []
        return list(zip(self._out["coarse"], self._out["fine"]))

    def _guesses(self, n: int, device) -> torch.Tensor:
        """Stacked [n-1,4,4] static accumulated y-rotation guesses (the
        accumulator advances for every frame, converged or not),
        built host-side in numpy."""
        acc = self.rads * np.arange(1, n, dtype=np.float64)
        c, s = np.cos(acc), np.sin(acc)
        t = np.tile(np.eye(4, dtype=np.float32), (n - 1, 1, 1))
        t[:, 0, 0] = c
        t[:, 0, 2] = s
        t[:, 2, 0] = -s
        t[:, 2, 2] = c
        return torch.from_numpy(t).to(device)


def _incremental_step(target: Cloud, cloud: Cloud, icp_cfg, leaf: float,
                      voxel_cap: int):
    """One pair of the loop path: voxel-downsample the source, ICP it
    against the accumulated target with no guess, and transform the full
    cloud by the result."""
    src_down = voxel_downsample(cloud, leaf, voxel_cap)
    res = icp_align(src_down, target, icp_cfg)
    return res, apply_transform_cloud(res.transform, cloud)


def _incremental_scan(clouds: List[Cloud], icp_cfg, leaf: float,
                      voxel_cap: int, cap: int):
    """The whole incremental chain on the scan path: the downsamples of
    frames 1..n-1 up front (they do not depend on the target), then per
    pair ICP against the accumulated full-resolution target and a block
    append of the transformed frame at offset ``frame_cap * i``. The
    pair's convergence gates its block's ``valid`` on the device, so no
    host sync decides a merge (the JAX ``lax.scan`` becomes this loop)."""
    first, rest = clouds[0], clouds[1:]
    frame_cap = first.capacity
    target = _block_append(Cloud.empty(cap, first.device, first.xyz.dtype), first, 0)
    src_downs = [voxel_downsample(c, leaf, voxel_cap) for c in rest]
    results = []
    for i, (src_down, cloud_i) in enumerate(zip(src_downs, rest), start=1):
        res = icp_align(src_down, target, icp_cfg)
        transformed = apply_transform_cloud(res.transform, cloud_i)
        target = _block_append(target, transformed, frame_cap * i,
                               gate=res.converged)
        results.append(res)
    return target, results


class IncrementalICP(RegistrationScheme):
    """Plain (non-edge) incremental registration (reference C3,
    src/incremental_icp.hpp): per cloud i >= 1, voxel-downsample the
    source, ICP against the accumulated target with NO initial guess, and
    on convergence merge the transformed full cloud. ``results`` holds
    one ``ICPResult`` per registered pair."""

    def __init__(self, config: PipelineConfig = PipelineConfig()):
        self.config = config
        self.results: List[ICPResult] = []

    def registration(self, clouds: Sequence) -> Cloud:
        cfg = self.config
        clouds = [_as_unorganized(c) for c in clouds]
        cap = sum(c.capacity for c in clouds)
        if (
            cfg.use_scan
            and len(clouds) >= 2
            and len({c.capacity for c in clouds}) == 1
            and len({c.normal is None for c in clouds}) == 1
        ):
            target, self.results = _incremental_scan(
                clouds, cfg.icp, cfg.voxel.leaf_size, cfg.voxel.max_points, cap,
            )
            return target
        target = merge_append(Cloud.empty(cap, clouds[0].device), clouds[0])
        self.results = []
        for cloud in clouds[1:]:
            res, transformed = _incremental_step(
                target, cloud, cfg.icp, cfg.voxel.leaf_size, cfg.voxel.max_points,
            )
            self.results.append(res)
            if bool(res.converged):  # host sync: the loop path's merge test
                target = merge_append(target, transformed)
        return target
