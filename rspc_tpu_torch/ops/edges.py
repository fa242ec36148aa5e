"""Organized edge features (port of ``rspc_tpu/ops/edges.py``), the
RGB_CANNY class the registration consumes: Canny on the mean-RGB
intensity image, compacted into a fixed-capacity edge cloud that carries
the integral-image normals.

Only ``edge_types=("rgb_canny",)`` is ported; the depth-discontinuity
and high-curvature classes and ``carry_cgrad`` raise
``NotImplementedError`` (ROADMAP.md Queue A).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud
from rspc_tpu_torch.config import EdgeConfig
from rspc_tpu_torch.ops.canny import _hysteresis, canny_masks
from rspc_tpu_torch.ops.normals import estimate_normals

_SHUFFLE_BLOCK = 128
_SENTINEL = 2**31 - 1


@functools.lru_cache(maxsize=4)
def _shuffle_priority_on(n: int, device: torch.device) -> torch.Tensor:
    """:func:`_shuffle_priority` as a tensor on ``device``, copied there
    once per frame size instead of once per frame."""
    return torch.from_numpy(_shuffle_priority(n)).to(device)


def _shuffle_priority(n: int) -> np.ndarray:
    """Constant i32[n] rank of each pixel under a fixed pseudo-random
    128-pixel-block shuffle (blocks permuted, order within a block kept),
    drawn with numpy exactly as the JAX package does: capacity truncation
    by ascending rank then drops pixels uniformly across the image."""
    nb = -(-n // _SHUFFLE_BLOCK)
    rng = np.random.default_rng(0x5EED)
    perm_b = rng.permutation(nb)
    inv = np.argsort(perm_b)
    i = np.arange(n)
    return (inv[i // _SHUFFLE_BLOCK] * _SHUFFLE_BLOCK + i % _SHUFFLE_BLOCK).astype(
        np.int32
    )


def _check_supported(config: EdgeConfig) -> None:
    if tuple(config.edge_types) != ("rgb_canny",) or config.carry_cgrad:
        raise NotImplementedError(
            "only edge_types=('rgb_canny',) without carry_cgrad is ported "
            "(ROADMAP.md Queue A: the 5-class edge labeler)"
        )


def _frame_inputs(cloud: OrganizedCloud, config: EdgeConfig):
    """Per frame: the normal image and its mask, and Canny's strong and
    weak masks (everything before the hysteresis)."""
    normals, n_valid = estimate_normals(cloud, config)
    rgb = cloud.rgb
    # the mean as XLA computes it, sum times the f32 reciprocal of 3:
    # Canny's NMS compares exact float ties on flat texture, so the
    # intensity must match the JAX package's bits
    intensity = (rgb[..., 0] + rgb[..., 1] + rgb[..., 2]) * float(np.float32(1) / np.float32(3))
    strong, weak = canny_masks(
        intensity, config.canny_low_threshold, config.canny_high_threshold
    )
    return normals, n_valid, strong, weak


def _compact(cloud: OrganizedCloud, rgb_edge, normals, config: EdgeConfig) -> Cloud:
    """Edge pixels keyed by shuffled rank, everything else past the end;
    one stable argsort keeps the first ``max_edge_points``."""
    flat = cloud.flatten()
    hw = flat.capacity
    sel = rgb_edge.reshape(-1) & flat.valid
    pri = _shuffle_priority_on(hw, sel.device)
    keys = torch.where(sel, pri, _SENTINEL)
    order = torch.argsort(keys, stable=True)[: config.max_edge_points]
    take = lambda x: x.index_select(0, order)
    out = Cloud(
        take(flat.xyz),
        take(flat.rgb),
        take(keys) != _SENTINEL,
        take(normals.reshape(hw, 3)),
    )
    return out.pad_to(config.max_edge_points)


def extract_edge_features(
    cloud: OrganizedCloud, config: EdgeConfig = EdgeConfig()
) -> Cloud:
    """The reference's ``extract_edge_features`` for one frame: the
    RGB_CANNY points as a compacted cloud carrying per-point normals."""
    feats, _, _ = extract_edge_features_batch([cloud], config)
    return feats[0]


def extract_edge_features_batch(clouds, config: EdgeConfig = EdgeConfig()):
    """Edge clouds of same-shaped frames, with ONE hysteresis call over
    the stacked ``[B, H, W]`` masks (the frame batch is kernel B3's grid).
    Returns ``(edge clouds, normal images, normal masks)`` per frame."""
    _check_supported(config)
    inputs = [_frame_inputs(c, config) for c in clouds]
    strong = torch.stack([x[2] for x in inputs])
    weak = torch.stack([x[3] for x in inputs])
    edges = _hysteresis(strong, weak)
    feats = [
        _compact(c, edges[i] & c.valid, inputs[i][0], config)
        for i, c in enumerate(clouds)
    ]
    return feats, [x[0] for x in inputs], [x[1] for x in inputs]
