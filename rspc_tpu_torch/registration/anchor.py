"""Refinement stages (port of ``rspc_tpu/registration/anchor.py``): the
per-pair full-cloud refine of the chain and the loop path, the anchor
refinement against frame 0, the progressive map anchor and the
pose-graph glue.

The JAX package runs the map anchor as a ``lax.scan`` and the pose
graph's pair alignments as a ``vmap`` of ``icp_align``; here the map
anchor is a loop over frames (its map prefix-dense at an offset kept on
the device, so no host sync decides a write), and the pose graph aligns
its pairs one at a time, so each pair stops at its own convergence as a
lane of the JAX ``vmap`` does.
"""

from __future__ import annotations

import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.ops.colorgrad import intensity
from rspc_tpu_torch.ops.transform import apply_transform, apply_transform_cloud
from rspc_tpu_torch.ops.umeyama import plane_fit
from rspc_tpu_torch.registration.bufferops import _rigid_inverse
from rspc_tpu_torch.registration.icp import _trust_region, icp_align
from rspc_tpu_torch.registration.measures import _capped_mean_sq, _inlier_stats, _nn_sweep
from rspc_tpu_torch.registration.posegraph import optimize_pose_graph


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
    point rmse. Stages with ``color_weight`` > 0 add the colored rows
    against the anchor's gradient field when it carries one
    (``RefineConfig.color``), stages with ``point_plane_mix`` > 0 the
    point term. Returns (totals [B,4,4], accepted bool[B])."""
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
        return table.index_select(0, idx.reshape(-1)).reshape(b, n_pts, *table.shape[1:])

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
    use_color = anchor.cgrad is not None and any(s.color_weight > 0.0 for s in stages)
    if use_color:
        i_src = intensity(fulls.rgb).to(cur.dtype)     # [b, n_pts]
        i_anchor = intensity(anchor.rgb).to(cur.dtype)  # [cap]
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
            color_kw = {}
            if use_color and s.color_weight > 0.0:
                # the photometric rows start from the RAW correspondence
                # mask (a large plane residual must not also mute a
                # point's colour row), with their own huber
                g = gather(anchor.cgrad, idx)
                di = gather(i_anchor, idx) - i_src
                w_c = w * s.color_weight
                if s.color_huber_delta is not None:
                    r_c = ((cur - q) * g).sum(-1) + di
                    w_c = w_c * torch.clamp(
                        s.color_huber_delta / torch.clamp(r_c.abs(), min=1e-12), max=1.0)
                color_kw = dict(cgrad=g, color_resid=di, color_weights=w_c)
            t_inc = plane_fit(cur, q, nrm, w_fit, point_mix=s.point_plane_mix, **color_kw)
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


def _pose_graph_refine(fulls: Cloud, totals: torch.Tensor, stages, skips,
                       gate_radius: float, min_overlap: float = 0.25,
                       max_points: int = 0) -> torch.Tensor:
    """Pose-graph relaxation over redundant pairwise constraints
    (RefineConfig.pose_graph). For every frame pair (i, i+off), off in
    ``skips``, frame j's full cloud (``fulls`` stacked ``[n, cap]``,
    strided to ``max_points``) is aligned onto frame i's by the
    point-to-plane ``stages`` from the current absolute poses, each pair
    stopping at its own convergence; the constraint is weighted by its
    inlier count and dropped below ``min_overlap`` inlier fraction. One
    prior (0, j) per frame holds its current pose at four times the
    median positive weight (1 when no pair kept a weight); the SE(3)
    solve (``posegraph.py``) then redistributes per-pair noise over the
    trajectory. Returns the refined totals ``[n-1, 4, 4]``."""
    n = fulls.valid.shape[0]
    dtype, dev = totals.dtype, totals.device
    pairs = [(i, i + off) for off in skips for i in range(n - off)]
    fulls_src = fulls
    if max_points and fulls.valid.shape[1] > max_points:
        step = -(-fulls.valid.shape[1] // max_points)
        fulls_src = fulls.map(lambda x: x[:, ::step])
    eye = torch.eye(4, dtype=dtype, device=dev)
    abs_poses = torch.cat([eye[None], totals], dim=0)
    inv_abs = _rigid_inverse(abs_poses)
    rels, n_inl, n_valid = [], [], []
    for i, j in pairs:
        tgt = fulls.map(lambda x: x[i])
        src = fulls_src.map(lambda x: x[j])
        rel = inv_abs[i] @ abs_poses[j]
        cur = apply_transform_cloud(rel, src)
        for stage_cfg in stages:
            res = icp_align(cur, tgt, stage_cfg)
            rel = res.transform @ rel
            cur = apply_transform_cloud(res.transform, cur)
        rels.append(rel)
        n_inl.append(_inlier_stats(cur, tgt, gate_radius)[0])
        n_valid.append(src.valid.to(dtype).sum())
    n_inl, n_valid = torch.stack(n_inl), torch.stack(n_valid)
    frac = n_inl / torch.clamp(n_valid, min=1.0)
    w = torch.where(frac >= min_overlap, n_inl, 0.0)

    # Anchor priors: the frame's current (anchor-refined) pose at a
    # typical measured weight, so the graph fuses the anchor solution
    # with the pairwise evidence instead of replacing it. The median is
    # numpy's nanmedian of the positive weights (the mean of the two
    # middle values), taken on the device.
    pos = w > 0
    k = pos.sum()
    srt = torch.sort(torch.where(pos, w, float("inf"))).values
    lo = torch.clamp((k - 1) // 2, min=0)
    hi = torch.clamp(k // 2, max=len(pairs) - 1)
    med = 0.5 * (srt[lo] + srt[hi])
    prior = torch.where(k > 0, 4.0 * med, 1.0).to(dtype)
    ei = torch.tensor([i for i, _ in pairs] + [0] * (n - 1), device=dev)
    ej = torch.tensor([j for _, j in pairs] + list(range(1, n)), device=dev)
    measures = torch.cat([torch.stack(rels), totals], dim=0)
    weights = torch.cat([w, prior.expand(n - 1)])
    refined, _ = optimize_pose_graph(totals, ei, ej, measures, weights)
    return refined


def _anchor_refine_map(fulls_all: Cloud, totals: torch.Tensor, stages, margin,
                       gate_radius=0.03, gate_inlier_keep=0.95, gate_rmse_blowup=1.5):
    """Progressive map anchoring (RefineConfig.anchor_mode="map"): frames
    refine in order against a growing map holding every previously
    accepted frame's refined full cloud (frame 0 seeds it), so each frame
    keeps full-overlap targets, and each accepted correction carries onto
    the next frame's start (``corr``).

    The map has capacity ``n * m`` and stays prefix-dense: frame i's
    cloud is written at the carried offset, and the offset advances by
    ``m`` only when the frame was accepted; a rejected frame's rows are
    written masked out and the next frame overwrites them. The offset
    lives on the device (``index_copy_`` at ``off + arange(m)``), so no
    host sync decides a write; the NN sweep stops at the map's last
    valid row, so early steps stay cheap.

    Acceptance mirrors :func:`_anchor_refine`'s gate (inlier keep, the
    point-to-plane residual tightened by ``margin``, the point-rmse
    blowup guard). ``stages`` are the anchor stages as they are: the JAX
    package switches them to its Pallas sweep here
    (``_map_anchor_stages``), while the port's sweep follows the tensors'
    device. Returns (totals [n-1,4,4], accepted bool[n-1])."""
    n, m = fulls_all.valid.shape
    dtype, dev = fulls_all.xyz.dtype, fulls_all.device
    cap = n * m
    use_color = fulls_all.cgrad is not None and any(s.color_weight > 0.0 for s in stages)

    def seeded(x):
        buf = torch.zeros((cap, *x.shape[2:]), dtype=x.dtype, device=dev)
        buf[:m] = x[0]
        return buf

    mx, mn, mv, mrgb = (seeded(x) for x in (fulls_all.xyz, fulls_all.normal,
                                             fulls_all.valid, fulls_all.rgb))
    mcg = seeded(fulls_all.cgrad) if use_color else None
    off = torch.full((), m, dtype=torch.int64, device=dev)
    rows = torch.arange(m, device=dev)
    corr = torch.eye(4, dtype=dtype, device=dev)
    r2 = gate_radius * gate_radius

    def gate_stats(c: Cloud, tgt: Cloud):
        d2, idx = _nn_sweep(c.xyz, c.valid, tgt.xyz, tgt.valid)
        idx = idx.long()
        inl = c.valid & torch.isfinite(d2) & (d2 < r2)
        cnt = inl.to(dtype).sum()
        msq = torch.where(inl, d2, 0.0).sum() / torch.clamp(cnt, min=1.0)
        msq = torch.where(cnt > 0, msq, float("inf"))
        rr = ((c.xyz - tgt.xyz.index_select(0, idx)) * tgt.normal.index_select(0, idx)).sum(-1)
        pmsq = torch.where(inl, rr * rr, 0.0).sum() / torch.clamp(cnt, min=1.0)
        pmsq = torch.where(cnt > 0, pmsq, float("inf"))
        return cnt, msq, pmsq

    totals_new, accepted_all = [], []
    for i in range(1, n):
        src = fulls_all.map(lambda x: x[i])
        total = totals[i - 1]
        base_t = corr @ total
        tgt = Cloud(mx, mrgb, mv, normal=mn, cgrad=mcg)
        src_t = apply_transform_cloud(base_t, src)
        _, rel, cur = _run_stages(tgt, src_t, stages)
        nb, rb, pb = gate_stats(src_t, tgt)
        na, ra, pa = gate_stats(cur, tgt)
        accepted = (na >= nb * gate_inlier_keep) & (pa <= pb * margin) & (
            ra <= rb * gate_rmse_blowup)
        t_new = torch.where(accepted, rel @ base_t, base_t)
        corr = torch.where(accepted, t_new @ _rigid_inverse(total), corr)
        placed = apply_transform_cloud(t_new, src)
        pos = off + rows
        mx.index_copy_(0, pos, placed.xyz)
        mn.index_copy_(0, pos, placed.normal)
        mv.index_copy_(0, pos, placed.valid & accepted)
        mrgb.index_copy_(0, pos, placed.rgb)
        if use_color:
            mcg.index_copy_(0, pos, placed.cgrad)
        off = off + torch.where(accepted, m, 0)
        totals_new.append(t_new)
        accepted_all.append(accepted)
    return torch.stack(totals_new), torch.stack(accepted_all)
