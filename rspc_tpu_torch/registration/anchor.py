"""Refinement stages (port of ``rspc_tpu/registration/anchor.py``): the
per-pair full-cloud refine of the chain and the loop path, and the
anchor refinement against frame 0. The progressive map anchor and the
pose graph are not ported yet (ROADMAP.md Queue A: robust_config)."""

from __future__ import annotations

import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.ops.transform import apply_transform, apply_transform_cloud
from rspc_tpu_torch.ops.umeyama import plane_fit
from rspc_tpu_torch.registration.icp import _trust_region, icp_align
from rspc_tpu_torch.registration.measures import _capped_mean_sq, _nn_sweep


def _run_stages(target_full: Cloud, src_t: Cloud, stages):
    """The annealed point-to-plane stage schedule; returns (the last
    stage's result, the relative transform, the final aligned cloud)."""
    cur = src_t
    rel = torch.eye(4, dtype=src_t.xyz.dtype, device=src_t.device)
    res = None
    for stage_cfg in stages:
        res = icp_align(cur, target_full, stage_cfg)
        cur = apply_transform_cloud(res.transform, cur)
        rel = res.transform @ rel
    return res, rel, cur


def _refine_step(target_full: Cloud, src_full: Cloud, base_t, stages, margin):
    """Full-cloud point-to-plane refinement (RefineConfig) against the
    accumulated surface from ``base_t``. The refined transform is kept
    only if it improves the capped NN score by ``margin``. Returns (the
    last stage's result, accepted bool, the total transform)."""
    src_t = apply_transform_cloud(base_t, src_full)
    res, rel, cur = _run_stages(target_full, src_t, stages)
    cap = stages[-1].max_correspondence_distance * 2.0
    before = _capped_mean_sq(src_t, target_full, cap)
    after = _capped_mean_sq(cur, target_full, cap)
    accepted = after <= before * margin
    return res, accepted, torch.where(accepted, rel @ base_t, base_t)


def _anchor_refine(
    anchor: Cloud,
    fulls: Cloud,
    totals: torch.Tensor,
    stages,
    margin,
    gate_radius=0.03,
    gate_inlier_keep=0.95,
    gate_rmse_blowup=1.5,
    max_points: int = 0,
):
    """Re-align every frame's full cloud (``fulls``, stacked ``[B, N]``)
    directly against frame 0's (``anchor``) from its chain transform.

    Each iteration flattens the [B, N] sources into ONE NN sweep against
    the shared anchor; the point-to-plane fits and trust regions run
    batched over frames. Stages run exactly ``max_iterations`` steps each
    (fixed count: no host sync). The overlap-aware acceptance gate keeps
    the chain transform of a frame whose refinement loses inliers, fails
    to tighten the point-to-plane residual by ``margin``, or blows up the
    point rmse. Returns (totals [B,4,4], accepted bool[B])."""
    if any(s.color_weight > 0.0 or s.point_plane_mix > 0.0 for s in stages):
        raise NotImplementedError(
            "colored / point-mixed anchor stages are not ported yet "
            "(ROADMAP.md Queue A)"
        )
    if max_points and fulls.valid.shape[1] > max_points:
        step = -(-fulls.valid.shape[1] // max_points)
        fulls = fulls.map(lambda x: x[:, ::step])
    b, n_pts = fulls.valid.shape
    flat_valid = fulls.valid.reshape(b * n_pts)

    def nn_flat(xyz_b):
        d2, idx = _nn_sweep(xyz_b.reshape(b * n_pts, 3), flat_valid,
                            anchor.xyz, anchor.valid, chunk=2048)
        return d2.reshape(b, n_pts), idx.reshape(b, n_pts).long()

    def gather(table, idx):
        return table.index_select(0, idx.reshape(-1)).reshape(b, n_pts, 3)

    def stats_from(d2, idx, xyz_b):
        inl = fulls.valid & torch.isfinite(d2) & (d2 < gate_radius**2)
        cnt = inl.to(d2.dtype).sum(dim=1)
        msq = torch.where(inl, d2, 0.0).sum(dim=1) / torch.clamp(cnt, min=1.0)
        msq = torch.where(cnt > 0, msq, float("inf"))
        r = ((xyz_b - gather(anchor.xyz, idx)) * gather(anchor.normal, idx)).sum(-1)
        pmsq = torch.where(inl, r * r, 0.0).sum(dim=1) / torch.clamp(cnt, min=1.0)
        pmsq = torch.where(cnt > 0, pmsq, float("inf"))
        return cnt, msq, pmsq

    src0 = apply_transform_cloud(totals, fulls)
    rel = torch.eye(4, dtype=totals.dtype, device=totals.device).expand(b, 4, 4)
    cur = src0.xyz
    before = None
    for s in stages:
        mcd2 = s.max_correspondence_distance**2
        for _ in range(s.max_iterations):
            d2, idx = nn_flat(cur)
            if before is None:
                # the first sweep runs at the src0 poses: exactly the
                # acceptance gate's "before" measurement
                before = stats_from(d2, idx, cur)
            w = ((d2 <= mcd2) & fulls.valid & torch.isfinite(d2)).to(cur.dtype)
            q = gather(anchor.xyz, idx)
            nrm = gather(anchor.normal, idx)
            w_fit = w
            if s.huber_delta is not None:
                r = ((cur - q) * nrm).sum(-1)
                w_fit = w * torch.clamp(
                    s.huber_delta / torch.clamp(r.abs(), min=1e-12), max=1.0
                )
            t_inc = plane_fit(cur, q, nrm, w_fit)
            t_inc = _trust_region(t_inc, cur, fulls.valid,
                                  s.max_correspondence_distance)
            rel = t_inc @ rel
            cur = apply_transform(t_inc, cur)
    if before is None:  # zero-iteration schedule
        before = stats_from(*nn_flat(src0.xyz), src0.xyz)
    nb, rb, pb = before
    na, ra, pa = stats_from(*nn_flat(cur), cur)
    accepted = (
        (na >= nb * gate_inlier_keep)
        & (pa <= pb * margin)
        & (ra <= rb * gate_rmse_blowup)
    )
    total = torch.where(accepted[:, None, None], rel @ totals, totals)
    return total, accepted
