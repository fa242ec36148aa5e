"""Registration schemes (port of ``rspc_tpu/registration/schemes.py``):
``NDTEdgeBasedRegistration`` -- NDT coarse + ICP fine on RGB-edge
clouds, chained incrementally over a frame sequence, with the static
per-frame yaw guesses -- on the fused path.

Not ported yet (ROADMAP.md Queue A): IMU guesses (``thetas``), the
per-frame loop path (``use_scan=False``), ``ICPEdgeBasedRegistration``
and ``IncrementalICP``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud
from rspc_tpu_torch.config import PipelineConfig
from rspc_tpu_torch.registration.chainscan import _registration_fused, _stack


class NDTEdgeBasedRegistration:
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
