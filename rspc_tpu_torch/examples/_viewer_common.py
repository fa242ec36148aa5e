"""Shared helpers of the standalone viewer examples.

The reference's examples use PCL's own viewers (CloudViewer /
PCLVisualizer, examples/visualizer/*.cpp), which display every finite
point and fit their camera to the cloud. The package's load path follows
the app's convention instead (librealsense marks invalid depth with the
origin; the app viewer skips z == 0, src/visualizer.hpp:86-88), which
would blank the reference's own 2-D sample clouds (example.pcd: 213
points, all z == 0). These helpers give the examples PCL-viewer
semantics:

* ``revalidate_finite`` marks every finite point valid;
* ``fit_to_view`` turns PCLVisualizer's camera fit into a cloud
  transform for the fixed-camera headless renderer (the cloud centred
  and pushed in front of the camera by 1.7x its extent).

Both keep the cloud on its device.
"""

from __future__ import annotations

import sys

import torch

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud


def as_cloud(cloud) -> Cloud:
    """An ``OrganizedCloud`` flattened, a ``Cloud`` as it is."""
    return cloud.flatten() if isinstance(cloud, OrganizedCloud) else cloud


def revalidate_finite(cloud: Cloud) -> Cloud:
    return Cloud(cloud.xyz, cloud.rgb, torch.isfinite(cloud.xyz).all(dim=-1))


def fit_to_view(cloud: Cloud) -> Cloud:
    """Centre the valid points and place them in front of the renderer's
    fixed camera (origin, looking +z, 60 deg field of view) at a distance
    where the whole cloud is in frame."""
    valid = cloud.valid
    if not bool(valid.any()):
        return cloud
    pts = cloud.xyz[valid]
    center = pts.mean(dim=0)
    extent = float(torch.linalg.vector_norm(pts - center, dim=1).max())
    push = torch.tensor([0.0, 0.0, max(1.7 * extent, 1e-3)], device=cloud.xyz.device)
    return Cloud(cloud.xyz - center + push, cloud.rgb, valid)


def run(main_fn, argv, doc: str, device) -> int:
    """``main_fn(args, device)`` with the usage on too few arguments and
    ``Type: message`` on stderr and exit 1 on any error (no card
    included)."""
    args = list(sys.argv if argv is None else argv)
    if len(args) < 2:
        print(doc)
        return 1
    try:
        return main_fn(args, device)
    except KeyboardInterrupt:
        raise
    except Exception as e:  # noqa: BLE001 -- report and exit 1, like the CLI
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
