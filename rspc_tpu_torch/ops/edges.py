"""Organized multi-modal edge detection, 5 label classes (port of
``rspc_tpu/ops/edges.py``, after ``pcl::OrganizedEdgeFromRGBNormals``,
src/edge_extractor.hpp:8-24):

  label 1  NAN_BOUNDARY    valid point bordering a hole whose far side
                           is not found within ``max_search_neighbors``
  label 2  OCCLUDING       closer side of a depth discontinuity
  label 3  OCCLUDED        farther side of a depth discontinuity
  label 4  HIGH_CURVATURE  Canny NMS + hysteresis on the normal image's
                           (nx, ny) (PCL OrganizedEdgeFromNormals)
  label 5  RGB_CANNY       Canny on the mean-RGB intensity; the only class
                           the reference consumes (edge_extractor.hpp:36-38)

Classes are exclusive; later stages overwrite earlier ones (depth ->
high curvature -> RGB), within the depth classes occluded > occluding >
nan_boundary; classes absent from ``edge_types`` are skipped. The edge
cloud is the RGB_CANNY points, compacted into a fixed capacity, carrying
the integral-image normals.

Frames of one shape are labelled together: the depth classes run on the
stacked ``[n, H, W]`` depth image (shifted on its last two axes), and
each Canny stage ends in ONE hysteresis call over all frames (kernel B3
on CUDA tensors), so a 5-class batch launches B3 twice. Under
``carry_cgrad`` the edge cloud also carries each pixel's tangent-plane
intensity gradient (``ops/colorgrad.py``), for the colored fine stage.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud, compact
from rspc_tpu_torch.config import EdgeConfig
from rspc_tpu_torch.ops.colorgrad import color_gradients
from rspc_tpu_torch.ops.canny import _hysteresis, canny_from_gradients, canny_masks
from rspc_tpu_torch.ops.image import shift_hw
from rspc_tpu_torch.ops.normals import estimate_normals

# label codes (0 = no edge; 1..5 in PCL's label_indices order)
LABEL_NONE = 0
LABEL_NAN_BOUNDARY = 1
LABEL_OCCLUDING = 2
LABEL_OCCLUDED = 3
LABEL_HIGH_CURVATURE = 4
LABEL_RGB_CANNY = 5

_DIRS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]

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


def _first_valid_along(z, valid, dr, dc, max_steps):
    """Per pixel of ``[..., H, W]``: the depth of the first VALID pixel at
    offset k*(dr, dc), k in [1, max_steps], and whether there is one.
    Log-doubling: ``F`` covers the next ``span`` pixels, ``F' =
    combine(F, shift(F, span))`` doubles it, and the windows of
    ``max_steps``'s binary digits compose the answer; exactly PCL's
    per-pixel walk of ``max_search_neighbors`` steps."""

    def shifted(st, steps):
        fz, fv = st
        return (shift_hw(fz, dr * steps, dc * steps, fill=0.0),
                shift_hw(fv, dr * steps, dc * steps, fill=False))

    def combine(a, b):
        """first valid of window a, then of window b"""
        return torch.where(a[1], a[0], b[0]), a[1] | b[1]

    f = shifted((z, valid), 1)  # the window of one pixel at offset 1
    span, covered, remaining, result = 1, 0, max_steps, None
    while remaining > 0:
        if remaining & 1:
            block = shifted(f, covered) if covered else f
            result = block if result is None else combine(result, block)
            covered += span
        remaining >>= 1
        if remaining:
            f = combine(f, shifted(f, span))
            span *= 2
    return result


def _depth_edges(z, valid, config: EdgeConfig):
    """(nan_boundary, occluding, occluded) bool of ``[..., H, W]`` depth
    ``z`` and mask ``valid``: a relative discontinuity |dz| > threshold *
    |z| to each of the 8 neighbours, or, across a hole, to the first
    valid pixel beyond it."""
    thresh = config.depth_discontinuity_threshold * z.abs()
    occluding = torch.zeros_like(valid)
    occluded = torch.zeros_like(valid)
    nan_boundary = torch.zeros_like(valid)
    for dr, dc in _DIRS:
        nbr_z = shift_hw(z, dr, dc, fill=0.0)
        nbr_v = shift_hw(valid, dr, dc, fill=False)
        dz = nbr_z - z
        occluding |= valid & nbr_v & (dz > thresh)
        occluded |= valid & nbr_v & (dz < -thresh)
        far_z, far_found = _first_valid_along(z, valid, dr, dc,
                                              config.max_search_neighbors)
        at_hole = valid & ~nbr_v
        dz_far = far_z - z
        occluding |= at_hole & far_found & (dz_far > thresh)
        occluded |= at_hole & far_found & (dz_far < -thresh)
        nan_boundary |= at_hole & (~far_found | (far_found & (dz_far.abs() <= thresh)))
    return nan_boundary, occluding, occluded


def _organized_edges_with_normals(clouds, config: EdgeConfig):
    """Labels ``i32[n, H, W]`` of same-shaped frames, plus each frame's
    normal image and its mask (estimated whatever the classes: the edge
    cloud carries them). Each Canny class is one hysteresis call over the
    stacked frames."""
    types = frozenset(config.edge_types)
    valid = torch.stack([c.valid for c in clouds])
    labels = torch.zeros(valid.shape, dtype=torch.int32, device=valid.device)
    if types & {"nan_boundary", "occluding", "occluded"}:
        z = torch.stack([c.xyz[..., 2] for c in clouds])
        nan_b, occluding, occluded = _depth_edges(z, valid, config)
        for name, mask, code in (("nan_boundary", nan_b, LABEL_NAN_BOUNDARY),
                                 ("occluding", occluding, LABEL_OCCLUDING),
                                 ("occluded", occluded, LABEL_OCCLUDED)):
            if name in types:
                labels = torch.where(mask, code, labels)
    est = [estimate_normals(c, config) for c in clouds]
    normals, n_valid = [e[0] for e in est], [e[1] for e in est]
    if "high_curvature" in types:
        nrm = torch.stack(normals)
        hc = canny_from_gradients(
            nrm[..., 0], nrm[..., 1], config.hc_canny_low_threshold,
            config.hc_canny_high_threshold, valid=torch.stack(n_valid),
        )
        labels = torch.where(hc & valid, LABEL_HIGH_CURVATURE, labels)
    if "rgb_canny" in types:
        masks = [_rgb_masks(c, config) for c in clouds]
        rgb_edge = _hysteresis(torch.stack([m[0] for m in masks]),
                               torch.stack([m[1] for m in masks]))
        labels = torch.where(rgb_edge & valid, LABEL_RGB_CANNY, labels)
    return labels, normals, n_valid


def extract_organized_edges_batch(clouds, config: EdgeConfig = EdgeConfig()):
    """5-class labels ``i32[n, H, W]`` (the LABEL_* codes) of same-shaped
    organized frames (PCL ``compute(labels, label_indices)`` per frame)."""
    return _organized_edges_with_normals(list(clouds), config)[0]


def extract_organized_edges(cloud: OrganizedCloud, config: EdgeConfig = EdgeConfig()):
    """5-class labels ``i32[H, W]`` of one organized frame."""
    return extract_organized_edges_batch([cloud], config)[0]


def edge_cloud(cloud: OrganizedCloud, labels, label: int, capacity: int) -> Cloud:
    """The points of one label class, compacted into a fixed-capacity
    cloud (PCL ``copyPointCloud(cloud, label_indices[k], out)``)."""
    flat = cloud.flatten()
    sel = (labels.reshape(-1) == label) & flat.valid
    return compact(Cloud(flat.xyz, flat.rgb, sel), capacity=capacity)


def _rgb_masks(cloud: OrganizedCloud, config: EdgeConfig):
    """Canny's strong and weak masks of a frame's mean-RGB intensity
    (everything of RGB_CANNY before the hysteresis)."""
    rgb = cloud.rgb
    # the mean as XLA computes it, sum times the f32 reciprocal of 3:
    # Canny's NMS compares exact float ties on flat texture, so the
    # intensity must match the JAX package's bits
    intensity = (rgb[..., 0] + rgb[..., 1] + rgb[..., 2]) * float(np.float32(1) / np.float32(3))
    return canny_masks(intensity, config.canny_low_threshold, config.canny_high_threshold)


def _frame_inputs(cloud: OrganizedCloud, config: EdgeConfig):
    """Per frame: the normal image and its mask, and the RGB Canny's
    strong and weak masks."""
    normals, n_valid = estimate_normals(cloud, config)
    return (normals, n_valid, *_rgb_masks(cloud, config))


def _compact(cloud: OrganizedCloud, rgb_edge, normals, config: EdgeConfig,
             cgrad=None) -> Cloud:
    """Edge pixels keyed by shuffled rank, everything else past the end;
    one stable argsort keeps the first ``max_edge_points``; ``cgrad``
    (``[H, W, 3]``) rides along when given."""
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
        cgrad=None if cgrad is None else take(cgrad.reshape(hw, 3)),
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
    """Edge clouds of same-shaped frames, labelled together (one
    hysteresis call per Canny class over the stacked ``[n, H, W]``
    masks). Returns ``(edge clouds, normal images, normal masks)`` per
    frame."""
    clouds = list(clouds)
    labels, normals, n_valid = _organized_edges_with_normals(clouds, config)
    feats = [
        _compact(c, labels[i] == LABEL_RGB_CANNY, normals[i], config,
                 color_gradients(c, normals[i], n_valid[i]) if config.carry_cgrad else None)
        for i, c in enumerate(clouds)
    ]
    return feats, normals, n_valid
