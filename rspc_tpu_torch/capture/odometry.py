"""Capture v2: full-resolution clouds and keypoint visual odometry (port of
``rspc_tpu/capture/odometry.py``).

The reference's ``get_clouds_new`` (src/capture_opencv.hpp:239-358), used
by ``--capture``:

  1. the throttled IMU capture loop of v1 (``replay.get_clouds``);
  2. full-resolution organized clouds (no 3/5 crop, :128-160);
  3. per consecutive frame pair: keypoints and descriptors on both
     colour frames, 2-NN ratio matching (Lowe 0.3) with the mutual
     check, a RANSAC homography computed and unused (:95);
  4. matched pixels lifted to 3-D through the organized clouds
     (``cloud->at(x, y)``, :332-343);
  5. grid-search translation and the frame's theta give a 4x4 pose per
     frame (identity for frame 0, :312-314).

``make_thetas_relative`` is a no-op in the reference (pass by value and
a wrong rebase index, :228-237); as in the JAX package, the intended
rebasing against theta_0 is done. The clouds never depend on the
odometry; the CLI saves them and drops the poses, like main.cpp:44-53.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from rspc_tpu_torch.capture.replay import ReplaySource, get_clouds
from rspc_tpu_torch.cloud import OrganizedCloud
from rspc_tpu_torch.config import CaptureConfig, TranslationEstimatorConfig
from rspc_tpu_torch.estimators.translation import estimate_translation
from rspc_tpu_torch.ops.keypoints import (
    compute_descriptors,
    detect_keypoints,
    match_descriptors,
)
from rspc_tpu_torch.ops.ransac import ransac_homography
from rspc_tpu_torch.ops.transform import make_rigid, rotation_matrix

N_ORIENTATIONS = 3  # descriptors per keypoint (Lowe's 0.8x multi-peak rule)


def _gray(rgb: torch.Tensor) -> torch.Tensor:
    """The channel mean as ``jnp.mean`` rounds it: the sum times the f32
    reciprocal of 3 (``torch.mean`` divides, which differs in the last
    bit for about a third of the pixels)."""
    return rgb.sum(dim=-1) * (1.0 / 3.0)


def _dump_matches(debug_dir, pair_idx, prev, cur, xy_ref, xy_cmp, good):
    """Side-by-side match visualization PNG (reference: drawMatches ->
    matches.jpg, capture_opencv.hpp:74-79)."""
    from rspc_tpu_torch.viz.png import write_png

    a = prev.rgb.cpu().numpy().astype(np.uint8)
    b = cur.rgb.cpu().numpy().astype(np.uint8)
    canvas = np.concatenate([a, b], axis=1)
    w = a.shape[1]
    for (x0, y0), (x1, y1) in zip(xy_ref[good], xy_cmp[good]):
        for (x, y) in ((int(x0), int(y0)), (int(x1) + w, int(y1))):
            ys = slice(max(y - 1, 0), min(y + 2, canvas.shape[0]))
            xs = slice(max(x - 1, 0), min(x + 2, canvas.shape[1]))
            canvas[ys, xs] = [255, 0, 0]
    os.makedirs(debug_dir, exist_ok=True)
    write_png(os.path.join(debug_dir, f"matches-{pair_idx}.png"), canvas)


def _pose_from_theta_translation(theta, translation: torch.Tensor) -> np.ndarray:
    """T * Rz(theta.x) * Ry(-theta.y) * Rx(theta.z), the axis mapping of
    the ICP scheme's guess (capture_opencv.hpp:346-349)."""
    th = torch.as_tensor(np.asarray(theta, np.float32), device=translation.device)
    r = (
        rotation_matrix(th[0], 2)
        @ rotation_matrix(-th[1], 1)
        @ rotation_matrix(th[2], 0)
    )
    return make_rigid(r, translation.to(torch.float32)).cpu().numpy()


def get_clouds_new(
    source: ReplaySource,
    nr_frames: int,
    config: CaptureConfig = CaptureConfig(center_crop=False),
    translation_config: TranslationEstimatorConfig = TranslationEstimatorConfig(),
    max_keypoints: int = 512,
    debug_dir: str | None = None,
    device="cuda",
) -> List[Tuple[OrganizedCloud, np.ndarray]]:
    """``[(cloud, pose 4x4)]`` per frame, the v2 capture contract; clouds
    and odometry on ``device`` (the card unless the caller names the CPU).

    ``debug_dir``: when set, writes per-pair match visualizations
    (``matches-{i}.png``: the two frames side by side with matched
    keypoints marked), the PNG form of the reference's drawMatches ->
    matches.jpg (capture_opencv.hpp:40-45,74-79)."""
    cfg = CaptureConfig(
        throttle_ns=config.throttle_ns,
        center_crop=False,  # v2 is always full resolution
        depth_scale=config.depth_scale,
        bgr_color=config.bgr_color,
    )
    clouds, thetas = get_clouds(source, nr_frames, cfg, device=device)
    if not clouds:
        return []

    # intended behavior of make_thetas_relative (no-op in the reference)
    rel_thetas = thetas.copy()
    rel_thetas[1:] = thetas[1:] - thetas[0]

    n_ori = N_ORIENTATIONS
    results: List[Tuple[OrganizedCloud, np.ndarray]] = [
        (clouds[0], np.eye(4, dtype=np.float32))
    ]
    for i in range(1, len(clouds)):
        prev, cur = clouds[i - 1], clouds[i]
        g0, g1 = _gray(prev.rgb), _gray(cur.rgb)

        xy0, _, v0, s0 = detect_keypoints(g0, max_keypoints=max_keypoints)
        xy1, _, v1, s1 = detect_keypoints(g1, max_keypoints=max_keypoints)
        # rows 3i..3i+2 belong to keypoint i; keypoints expand by repeat
        d0, v0e = compute_descriptors(g0, xy0, v0, s0, num_orientations=n_ori)
        d1, v1e = compute_descriptors(g1, xy1, v1, s1, num_orientations=n_ori)
        idx_b, good = match_descriptors(d0, v0e, d1, v1e, ratio=0.3, mutual_group=n_ori)
        xy0e = xy0.repeat_interleave(n_ori, 0)
        xy1e = xy1.repeat_interleave(n_ori, 0)

        xy_ref = xy0e.cpu().numpy()
        xy_cmp = xy1e[idx_b].cpu().numpy()
        good_np = good.cpu().numpy()

        if debug_dir is not None:
            _dump_matches(debug_dir, i, prev, cur, xy_ref, xy_cmp, good_np)

        # homography for parity (unused downstream, like the reference)
        ransac_homography(xy1e[idx_b], xy0e, good)

        # lift matched pixels to 3-D via the organized clouds (cloud->at(x,y))
        def lift(oc, xy):
            xs = np.clip(xy[:, 0].astype(int), 0, oc.width - 1)
            ys = np.clip(xy[:, 1].astype(int), 0, oc.height - 1)
            return oc.xyz.cpu().numpy()[ys, xs], oc.valid.cpu().numpy()[ys, xs]

        p_ref, ok_r = lift(prev, xy_ref)
        p_cmp, ok_c = lift(cur, xy_cmp)
        w = (good_np & ok_r & ok_c).astype(np.float32)

        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        if w.sum() >= 3:
            translation = estimate_translation(
                on(p_ref), on(p_cmp), on(rel_thetas[i].astype(np.float32)),
                weights=on(w),
                max_iterations=translation_config.max_iterations,
                step=translation_config.step,
            )
        else:
            translation = torch.zeros(3, dtype=torch.float32, device=device)

        results.append((cur, _pose_from_theta_translation(rel_thetas[i], translation)))
    return results
