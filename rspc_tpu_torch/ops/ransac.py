"""Batched RANSAC homography estimation (port of ``rspc_tpu/ops/ransac.py``).

The reference's ``cv::findHomography(RANSAC)`` (src/capture_opencv.hpp:96-99),
computed and explicitly unused. All hypotheses are drawn up front and
solved as one batched 8x9 SVD, then scored by one ``[H, K]`` inlier count.

The draws cannot be the JAX package's (``jax.random.categorical`` under
``PRNGKey(seed)``): they come from a CPU ``torch.Generator`` seeded with
``seed``, so they are the same on every device.
"""

from __future__ import annotations

import torch


def _dlt_homography(src4: torch.Tensor, dst4: torch.Tensor) -> torch.Tensor:
    """4-point DLT on ``[..., 4, 2]`` point sets: the 8x9 system's null
    vector, h22-normalised, as ``[..., 3, 3]``."""
    x, y = src4[..., 0], src4[..., 1]
    u, v = dst4[..., 0], dst4[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows_u = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], dim=-1)
    rows_v = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    a = torch.cat([rows_u, rows_v], dim=-2)  # [..., 8, 9]
    # null vector = right-singular vector of the least singular value
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    h = vt[..., -1, :]
    h8 = h[..., 8:9]
    h = h / torch.where(torch.abs(h8) > 1e-12, h8, 1.0)
    return h.reshape(*h.shape[:-1], 3, 3)


def ransac_homography(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    threshold: float = 3.0,
    num_hypotheses: int = 512,
    seed: int = 0,
):
    """Estimate a homography mapping ``src`` -> ``dst`` (pixel coords).

    src, dst: f32[K,2]; valid: bool[K]. Each hypothesis draws 4 matches
    uniformly among the valid ones (among all when none is valid).
    Returns (H f32[3,3], inlier_mask bool[K], n_inliers i32): the
    hypothesis with the most inliers (squared reprojection error under
    ``threshold``^2), the first on ties; non-finite hypotheses never win."""
    k = src.shape[0]
    dev = src.device
    gen = torch.Generator().manual_seed(seed)
    weights = valid.cpu().to(torch.float64)
    if not bool(weights.any()):
        weights = torch.ones(k, dtype=torch.float64)
    picks = torch.multinomial(weights, num_hypotheses * 4, replacement=True,
                              generator=gen).to(dev)

    src_sets = src[picks].reshape(num_hypotheses, 4, 2)
    dst_sets = dst[picks].reshape(num_hypotheses, 4, 2)
    hs = _dlt_homography(src_sets, dst_sets)  # [H,3,3]

    # projections as explicit products (no reduced-precision matmul)
    proj = (hs[:, None, :, 0] * src[None, :, 0, None]
            + hs[:, None, :, 1] * src[None, :, 1, None]
            + hs[:, None, :, 2])  # [H,K,3]
    zden = torch.where(torch.abs(proj[..., 2]) > 1e-12, proj[..., 2], 1e-12)
    uv = proj[..., :2] / zden[..., None]
    err = torch.sum((uv - dst[None, :, :]) ** 2, dim=-1)  # [H,K]
    inl = (err < threshold**2) & valid[None, :]
    counts = inl.sum(dim=1)
    finite = torch.isfinite(hs.reshape(num_hypotheses, -1)).all(dim=-1)
    counts = torch.where(finite, counts, -1)
    best = torch.where(counts == counts.max(), torch.arange(num_hypotheses, device=dev),
                       num_hypotheses).min()
    return hs[best], inl[best], counts[best].to(torch.int32)
