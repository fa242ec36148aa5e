"""Phase-1 preparation and the fused frame chain (port of
``rspc_tpu/registration/chainscan.py``).

``_registration_fused`` runs the whole registration: phase 1 (normals,
RGB Canny with one batched hysteresis, edge compaction, the refine
clouds' voxel means), the frame chain (voxel downsample, incremental NDT
coarse, the coarse guard, fine ICP, ``merge_append``), the anchor
refinement against frame 0 and the global cloud. The JAX ``lax.scan``
over frames becomes a Python loop; the per-frame convergence gate folds
into the merge scatters, so no host sync decides a merge.

Not ported yet (ROADMAP.md Queue A): the ICP coarse stage, the warm
start, the rescue stage, the in-chain refine, the map anchor, the pose
graph and the sharded form.
"""

from __future__ import annotations

import dataclasses

import torch

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud
from rspc_tpu_torch.ops.edges import extract_edge_features_batch
from rspc_tpu_torch.ops.transform import apply_transform, apply_transform_cloud
from rspc_tpu_torch.ops.voxel import voxel_downsample
from rspc_tpu_torch.registration.anchor import _anchor_refine
from rspc_tpu_torch.registration.bufferops import _stride_cloud, merge_append
from rspc_tpu_torch.registration.icp import icp_align
from rspc_tpu_torch.registration.ndt import (
    ndt_align,
    ndt_grid_from_moments,
    ndt_grid_init,
    ndt_grid_origin,
    ndt_grid_update_moments,
)
from rspc_tpu_torch.registration.pairsteps import _GUARD_MAX_POINTS, _guard_best


def _stack(clouds):
    """Stack same-capacity clouds along a new leading axis."""
    first = clouds[0]
    return type(first)(**{
        f.name: (None if getattr(first, f.name) is None
                 else torch.stack([getattr(c, f.name) for c in clouds]))
        for f in dataclasses.fields(first)
    })


def _prepare_full_down(oc: OrganizedCloud, normals, n_valid, leaf, cap,
                       dec=1, purity=0.0) -> Cloud:
    """The refine stage's cloud: integral-image normals on the organized
    frame, every ``dec``-th pixel per axis, voxel means."""
    xyz, rgb, valid, nrm = oc.xyz, oc.rgb, oc.valid & n_valid, normals
    if dec > 1:
        xyz, rgb, valid, nrm = (x[::dec, ::dec] for x in (xyz, rgb, valid, nrm))
    m = xyz.shape[0] * xyz.shape[1]
    flat = Cloud(xyz.reshape(m, 3), rgb.reshape(m, 3), valid.reshape(m),
                 normal=nrm.reshape(m, 3))
    return voxel_downsample(flat, leaf, cap, min_normal_purity=purity)


def _phase1_prepare(frames, edge_cfg, leaf, cap, with_full, dec=1,
                    purity=0.0, color=False):
    """Phase 1 for all frames: stacked edge clouds ``[n, edge_cap]`` and,
    when ``with_full``, the stacked refine clouds ``[n, cap]``. The Canny
    hysteresis of all frames is one batched call."""
    if color:
        raise NotImplementedError(
            "colored refine clouds are not ported yet (ROADMAP.md Queue A)"
        )
    feats, normals, n_valid = extract_edge_features_batch(frames, edge_cfg)
    full = None
    if with_full:
        full = _stack([
            _prepare_full_down(oc, normals[i], n_valid[i], leaf, cap, dec, purity)
            for i, oc in enumerate(frames)
        ])
    return _stack(feats), full


def _chain_scan(edges_all: Cloud, guesses, ndt_cfg, icp_cfg, leaf: float,
                voxel_cap: int, target_cap: int, coarse_guard_cap: float):
    """The NDT frame chain: per pair, NDT coarse against the incremental
    moment grid from the guess, the never-worsen guard, fine ICP on the
    accumulated edge target, then the gated merges."""
    n = edges_all.valid.shape[0]
    edges_down = [
        voxel_downsample(edges_all.map(lambda x: x[i]), leaf, voxel_cap)
        for i in range(n)
    ]
    target0 = edges_down[0]
    target = merge_append(
        Cloud.empty(target_cap, target0.device,
                    with_normal=target0.normal is not None),
        target0,
    )
    origin = ndt_grid_origin(target0, ndt_cfg)
    moments = ndt_grid_update_moments(
        ndt_grid_init(origin, ndt_cfg).moments, origin, target0, ndt_cfg
    )
    coarse_s, fine_s, totals = [], [], []
    for i in range(1, n):
        edge_i, guess = edges_down[i], guesses[i - 1]
        grid = ndt_grid_from_moments(moments, origin, ndt_cfg)
        coarse = ndt_align(edge_i, grid, ndt_cfg, guess)
        if coarse_guard_cap > 0.0:
            coarse = dataclasses.replace(
                coarse,
                transform=_guard_best(
                    [coarse.transform, guess],
                    _stride_cloud(edge_i, _GUARD_MAX_POINTS),
                    target, coarse_guard_cap,
                ),
            )
        aligned = apply_transform_cloud(coarse.transform, edge_i)
        fine = icp_align(aligned, target, icp_cfg)
        total = fine.transform @ coarse.transform
        conv = fine.converged
        edge_total = apply_transform_cloud(total, edge_i)
        target = merge_append(target, edge_total, gate=conv)
        moments = ndt_grid_update_moments(moments, origin, edge_total, ndt_cfg,
                                          gate=conv)
        coarse_s.append(coarse)
        fine_s.append(fine)
        totals.append(total)
    return {
        "target": target,
        "coarse": coarse_s,
        "fine": fine_s,
        "totals": torch.stack(totals),
        "edges_down0": target0,
    }


def _registration_fused(stacked: OrganizedCloud, frames, guesses, edge_cfg,
                        ndt_cfg, icp_cfg, refine_cfg, leaf: float,
                        voxel_cap: int, coarse_guard_cap: float):
    """The whole registration: phase 1, the frame chain, the anchor
    refinement and the global cloud. ``frames`` are the per-frame
    ``OrganizedCloud``s, ``stacked`` the same frames stacked ``[n, H, W]``."""
    r = refine_cfg
    if r.enabled and (r.chain or r.pose_graph or r.anchor_mode != "first"):
        raise NotImplementedError(
            "only the anchor-to-first refine is ported (ROADMAP.md Queue A)"
        )
    n = len(frames)
    feats, full = _phase1_prepare(
        frames, edge_cfg, r.leaf_size, r.max_points, r.enabled, r.decimate,
        r.normal_purity, r.color,
    )
    out = _chain_scan(feats, guesses, ndt_cfg, icp_cfg, leaf, voxel_cap,
                      voxel_cap * n, coarse_guard_cap)
    totals = out["totals"]
    accepted = None
    if r.enabled and r.anchor_to_first:
        totals, accepted = _anchor_refine(
            full.map(lambda x: x[0]), full.map(lambda x: x[1:]), totals,
            r.anchor_stages, 1.0, r.gate_radius, r.gate_inlier_keep,
            r.gate_rmse_blowup, max_points=r.anchor_max_points,
        )
    out["totals"] = totals
    out["anchor_accepted"] = accepted
    out["features"] = feats
    out["full_down"] = full

    # global cloud: one batched transform of the stacked originals, gated
    # per frame by convergence (or by the anchor gate's acceptance)
    merge_ok = torch.stack([f.converged for f in out["fine"]])
    if accepted is not None:
        merge_ok = merge_ok | accepted
    hw = stacked.height * stacked.width
    eye = torch.eye(4, dtype=totals.dtype, device=totals.device)
    all_t = torch.cat([eye[None], totals], dim=0)
    conv_all = torch.cat([torch.ones_like(merge_ok[:1]), merge_ok])
    xyz = apply_transform(all_t, stacked.xyz.reshape(n, hw, 3))
    out["global"] = Cloud(
        xyz=xyz.reshape(n * hw, 3),
        rgb=stacked.rgb.reshape(n * hw, 3),
        valid=(stacked.valid.reshape(n, hw) & conv_all[:, None]).reshape(n * hw),
    )
    return out
