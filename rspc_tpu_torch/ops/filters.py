"""Point-cloud filters: pass-through and statistical outlier removal
(port of ``rspc_tpu/ops/filters.py``).

The equivalents of ``pcl::PassThrough`` and
``pcl::StatisticalOutlierRemoval``. In the reference they appear only in
dead code (``filter_pcl``, src/capture.hpp:112-132, never called); they
follow its intended behaviour. Both are mask updates over fixed-capacity
clouds, computed on the cloud's device.
"""

from __future__ import annotations

import math

import torch

from rspc_tpu_torch.cloud import Cloud

_FIELD_IDX = {"x": 0, "y": 1, "z": 2}


def passthrough(cloud: Cloud, field: str = "z", lower: float = 0.2,
                upper: float = 2.5) -> Cloud:
    """Keep points whose ``field`` coordinate lies in [lower, upper]
    (pcl::PassThrough; the reference's intended limits were (0.2, 2.5),
    capture.hpp:119-122)."""
    v = cloud.xyz[:, _FIELD_IDX[field]]
    keep = cloud.valid & (v >= lower) & (v <= upper)
    return Cloud(cloud.xyz, cloud.rgb, keep)


def statistical_outlier_removal(
    cloud: Cloud,
    mean_k: int = 50,
    stddev_mult: float = 1.5,
    chunk: int = 1024,
) -> Cloud:
    """pcl::StatisticalOutlierRemoval: each point's mean distance to its
    ``mean_k`` nearest valid neighbours (itself excluded), then drop the
    points whose mean distance exceeds the global mean plus
    ``stddev_mult`` global standard deviations.

    The kNN is a brute-force sweep over ``chunk`` source rows at a time:
    d^2 is the explicit sum of squared coordinate differences, as in the
    JAX package (``torch.cdist`` switches to the matrix-product form past
    25 rows and rounds otherwise), and only the ``mean_k`` smallest
    values are kept, in ascending order. One tile holds ``[chunk, N]``
    floats a few times over (1.2 GB each at chunk 1024, N = 307,200)."""
    xyz, valid = cloud.xyz, cloud.valid
    n = cloud.capacity
    tgt = torch.arange(n, device=xyz.device)
    mean_dists = []
    for b in range(0, n, chunk):
        s = xyz[b:b + chunk]
        rows = b + torch.arange(len(s), device=xyz.device)
        d2 = ((s[:, None, 0] - xyz[None, :, 0]) ** 2
              + (s[:, None, 1] - xyz[None, :, 1]) ** 2
              + (s[:, None, 2] - xyz[None, :, 2]) ** 2)
        # exclude self and invalid targets
        d2 = torch.where(valid[None, :] & (tgt[None, :] != rows[:, None]), d2, math.inf)
        near = torch.topk(d2, mean_k, dim=1, largest=False, sorted=True).values
        dists = torch.sqrt(torch.clamp(near, min=0.0))
        finite = torch.isfinite(dists)
        cnt = torch.clamp(finite.sum(dim=1), min=1)
        mean_d = torch.where(finite, dists, 0.0).sum(dim=1) / cnt
        mean_dists.append(torch.where(valid[b:b + chunk], mean_d, math.nan))
    mean_dists = torch.cat(mean_dists)

    ok = valid & torch.isfinite(mean_dists)
    cnt = torch.clamp(ok.sum(), min=1)
    mu = torch.where(ok, mean_dists, 0.0).sum() / cnt
    var = torch.where(ok, (mean_dists - mu) ** 2, 0.0).sum() / cnt
    thresh = mu + stddev_mult * torch.sqrt(var)
    return Cloud(cloud.xyz, cloud.rgb, ok & (mean_dists <= thresh))
