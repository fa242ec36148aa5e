"""Grid-search translation from keypoint correspondences (port of
``rspc_tpu/estimators/translation.py``).

The reference's ``TranslationEstimator`` (src/translation_estimator.hpp):
per axis, 500 candidate shifts ``m_i = -(max_iterations/200) + step*i``
(:37-42), each scored by the sum of squared differences between the
rotated comparison keypoints shifted by ``m_i`` and the reference
keypoints, the first minimum kept (its strict ``<`` scan, :60-67). The
rotation is ``Rz(rot.x) @ Ry(-rot.y) @ Rx(rot.z)`` (:17-19), and the
per-axis minima combine diagonally (:28-32). One ``[C, 3]`` score tensor
covers every candidate and axis.
"""

from __future__ import annotations

import torch

from rspc_tpu_torch.ops.transform import rotate_points, rotation_matrix


def estimate_translation(
    ref_kpts: torch.Tensor,
    cmp_kpts: torch.Tensor,
    rotation_theta: torch.Tensor,
    weights: torch.Tensor | None = None,
    max_iterations: int = 500,
    step: float = 0.01,
) -> torch.Tensor:
    """Estimate a translation ``f32[3]`` from paired 3-D keypoints.

    ref_kpts/cmp_kpts: ``f32[K,3]``; rotation_theta: the IMU theta with
    the reference's axis mapping; weights: optional ``f32[K]`` validity
    mask (None weighs every pair 1, the reference's unpadded case)."""
    dtype = ref_kpts.dtype
    theta = torch.as_tensor(rotation_theta, dtype=dtype, device=ref_kpts.device)
    r = (
        rotation_matrix(theta[0], 2)
        @ rotation_matrix(-theta[1], 1)
        @ rotation_matrix(theta[2], 0)
    )
    rot_cmp = rotate_points(r, cmp_kpts)  # [K,3]

    base = -1.0 * (max_iterations / 200.0)
    mags = base + step * torch.arange(max_iterations, dtype=dtype, device=ref_kpts.device)

    diff = rot_cmp - ref_kpts  # [K,3]
    w = (torch.ones(ref_kpts.shape[0], dtype=dtype, device=ref_kpts.device)
         if weights is None else weights.to(dtype))
    # score[c, a] = sum_k w_k (diff[k,a] + m_c)^2
    scores = torch.sum(w[None, :, None] * (diff[None, :, :] + mags[:, None, None]) ** 2,
                       dim=1)  # [C,3]
    # the first minimum on ties, like the reference's strict < scan
    pos = torch.arange(max_iterations, device=scores.device)[:, None]
    best = torch.where(scores == scores.amin(dim=0), pos, max_iterations).amin(dim=0)
    return mags[best]
