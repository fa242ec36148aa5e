"""Feature quality of the port's visual odometry on known warps, the
port's counterpart of ``tools/feature_quality.py``.

On synthetic frames warped by known homographies it measures:

  * detector repeatability: the share of the keypoints of A whose mapped
    location has a keypoint of B within ``tol`` px;
  * the match inlier rate: the share of the ratio-test survivors that
    agree with the true homography within ``tol`` px;
  * the matches per frame at the reference's ratio 0.3
    (src/capture_opencv.hpp:66) and at 0.7.

The options are the JAX package's odometry defaults (3 octaves over the
2x-upsampled base, 3 orientations, the mutual check, the scale gate
off); ``first_octave=0`` and ``scale_gate`` are the two the odometry does
not set. OpenCV's SIFT, the JAX tool's yardstick, is not run here: the
port needs no ``cv2``. The warps are ``warp_perspective``'s, which
follows ``cv2.warpPerspective``.

Usage: python -m rspc_tpu_torch.tools.feature_quality
(on the card; tests call ``main(device="cpu")``)
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from rspc_tpu_torch.capture.synthetic import SyntheticSequence
from rspc_tpu_torch.ops.deproject import Intrinsics
from rspc_tpu_torch.ops.keypoints import (
    compute_descriptors,
    detect_keypoints,
    match_descriptors,
)


def test_images(size=(320, 240), device="cuda"):
    """Two uint8 grayscale frames (numpy ``[H, W]``) of the synthetic room
    (checker and stripe texture, box edges), rendered on ``device``,
    0.3 rad of yaw apart."""
    w, h = size
    seq = SyntheticSequence(n_frames=2, yaw_step=-0.3, intr=Intrinsics.simple(w, h))
    grays = []
    for _, color in seq.frames(device):
        c = color.cpu().numpy().astype(np.float32)
        grays.append((0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2])
                     .astype(np.uint8))
    return grays


def _rotation_2d(center, angle_deg: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D`` as a 3x3 float64 matrix."""
    a = math.radians(angle_deg)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy],
                     [0.0, 0.0, 1.0]])


def homographies(w, h):
    """Named ground-truth warps (moderate, odometry-scale)."""
    c = (w / 2.0, h / 2.0)
    p = np.eye(3)
    p[2, 0] = 2.5e-4
    p[0, 2] = 4.0
    return {
        "shift": np.array([[1, 0, 9.0], [0, 1, -6.0], [0, 0, 1]], np.float64),
        "rotate8": _rotation_2d(c, 8.0, 1.0),
        "scale1.12": _rotation_2d(c, 0.0, 1.12),
        "perspective": p,
    }


def warp_perspective(gray: np.ndarray, hmat: np.ndarray) -> np.ndarray:
    """``cv2.warpPerspective(gray, hmat, (W, H))`` of a uint8 ``[H, W]``
    image: ``dst(x) = src(hmat^-1 x)``, bilinear, 0 outside the source,
    rounded half to even. Source coordinates and weights are float32, as
    in OpenCV 5's warp (its earlier versions quantised the weights to
    1/32 px)."""
    h, w = gray.shape
    m = np.linalg.inv(np.asarray(hmat, np.float64)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    den = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    sx = (m[0, 0] * xs + m[0, 1] * ys + m[0, 2]) / den
    sy = (m[1, 0] * xs + m[1, 1] * ys + m[1, 2]) / den
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    src = gray.astype(np.float32)
    one = np.float32(1)

    def tap(dy, dx):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return np.where(inside, src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], 0)

    out = (tap(0, 0) * (one - fx) * (one - fy) + tap(0, 1) * fx * (one - fy)
           + tap(1, 0) * (one - fx) * fy + tap(1, 1) * fx * fy)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _apply_h(hmat, xy):
    xy1 = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    m = xy1 @ hmat.T
    return m[:, :2] / m[:, 2:3]


def match_pair(
    gray_a, gray_b, ratio=0.3, max_kp=512, num_orientations=3, scale_gate=0.0,
    num_octaves=3, mutual=True, first_octave=-1, device="cuda",
):
    """The features of both frames and their matches, on ``device``:
    ``(xy_a, valid_a, xy_b, valid_b, idx_b, good)`` with one row per
    descriptor (each keypoint's xy repeated ``num_orientations`` times,
    OpenCV's duplicated-keypoint list)."""
    n = num_orientations
    out = []
    for gray in (gray_a, gray_b):
        g = torch.as_tensor(np.asarray(gray), device=device)
        xy, _, valid, sigma = detect_keypoints(
            g, max_keypoints=max_kp, num_octaves=num_octaves, first_octave=first_octave)
        desc = compute_descriptors(g, xy, valid, sigma, num_octaves=num_octaves,
                                   first_octave=first_octave, num_orientations=n)
        desc, valid_n = (desc, valid) if n == 1 else desc
        out.append((xy.repeat_interleave(n, 0), valid_n, desc, sigma.repeat_interleave(n, 0)))
    (xy_a, va, da, sa), (xy_b, vb, db, sb) = out
    idx, good = match_descriptors(da, va, db, vb, ratio=ratio, sigma_a=sa, sigma_b=sb,
                                  scale_gate=scale_gate, mutual_group=n if mutual else 0)
    return xy_a, va, xy_b, vb, idx, good


def measure_ours(
    gray_a, gray_b, hmat, tol=3.0, ratio=0.3, max_kp=512, num_orientations=3,
    scale_gate=0.0, num_octaves=3, mutual=True, first_octave=-1, device="cuda",
):
    """``_stats`` of ``match_pair``'s features against ``hmat``."""
    got = match_pair(gray_a, gray_b, ratio, max_kp, num_orientations, scale_gate,
                     num_octaves, mutual, first_octave, device)
    return _stats(*(t.cpu().numpy() for t in got), hmat, tol, np.shape(gray_a))


def _stats(xy_a, va, xy_b, vb, idx, good, hmat, tol, shape):
    h, w = shape
    mapped = _apply_h(hmat, xy_a)
    in_view = (
        (mapped[:, 0] >= 8)
        & (mapped[:, 0] < w - 8)
        & (mapped[:, 1] >= 8)
        & (mapped[:, 1] < h - 8)
        & va
    )
    # repeatability: mapped A keypoint has a B keypoint within tol
    bxy = xy_b[vb]
    rep_hits = 0
    for p in mapped[in_view]:
        if len(bxy) and np.min(((bxy - p) ** 2).sum(1)) <= tol * tol:
            rep_hits += 1
    repeatability = rep_hits / max(in_view.sum(), 1)

    good = good & in_view
    n_matches = int(good.sum())
    if n_matches:
        err = np.sqrt(
            ((xy_b[idx[good]] - mapped[good]) ** 2).sum(1)
        )
        inlier_rate = float((err <= tol).mean())
    else:
        inlier_rate = float("nan")
    return {
        "kp_a": int(va.sum()),
        "kp_b": int(vb.sum()),
        "repeatability": float(repeatability),
        "n_matches": n_matches,
        "inlier_rate": inlier_rate,
    }


def run(tol=3.0, device="cuda"):
    """``(warp, ratio, stats)`` for every warp at ratios 0.3 and 0.7."""
    ga = test_images(device=device)[0]
    rows = []
    for name, hmat in homographies(ga.shape[1], ga.shape[0]).items():
        gb = warp_perspective(ga, hmat)
        for ratio in (0.3, 0.7):
            rows.append((name, ratio, measure_ours(ga, gb, hmat, tol, ratio, device=device)))
    return rows


def main(device="cuda") -> int:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("feature_quality: no CUDA device available", file=sys.stderr)
        return 1
    print(f"{'warp':<12} {'ratio':<6} {'kp':<5} {'repeat':<8} {'matches':<8} inliers")
    for name, ratio, r in run(device=device):
        print(f"{name:<12} {ratio:<6} {r['kp_a']:<5} {r['repeatability']:<8.3f} "
              f"{r['n_matches']:<8} {r['inlier_rate']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
