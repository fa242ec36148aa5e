"""Phase-1 preparation and the fused frame chain (port of
``rspc_tpu/registration/chainscan.py``).

``_phase1_prepare`` is phase 1 for stacked frames (normals, the edge
labels with one batched hysteresis per Canny class, edge compaction,
the refine clouds' voxel means); ``_chain_scan`` the frame chain (voxel
downsample; NDT coarse against the incremental moment grid or coarse
ICP against the accumulated target; the coarse guard; fine ICP; the
in-chain refine; ``merge_append``; under ``warm_start`` the
constant-velocity prediction, under a rescue threshold the gated
wide-cap rescue), ``_anchor_stages`` the anchor refinement (against
frame 0, or the progressive map) and the pose graph, and
``_assemble_global`` the global cloud; ``_registration_body`` runs the
last three in that order and ``_registration_fused`` is phase 1 and the
body, one sequence's whole registration (the schemes' fused path and
``parallel/chain.py`` call them). The JAX ``lax.scan`` over frames
becomes a Python loop; the per-frame convergence gate folds into the
merge scatters, so no host sync decides a merge (the rescue's gate is
one sync per pair, ``pairsteps.py``).

``group`` (the JAX ``psum_axis``): every pair solve's source (coarse
NDT or ICP, fine ICP) is capped or strided as on one rank, then sharded
over the group's ranks by the solver (``ops/collectives.py::shard_cloud``),
and the solves all-reduce their moments; the guard, the rescue, the
refine, the merges, the anchor and the pose graph stay replicated.
"""

from __future__ import annotations

import dataclasses

import torch

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud
from rspc_tpu_torch.ops.edges import extract_edge_features_batch
from rspc_tpu_torch.ops.transform import apply_transform_cloud
from rspc_tpu_torch.ops.voxel import voxel_downsample
from rspc_tpu_torch.ops.colorgrad import color_gradients
from rspc_tpu_torch.registration.anchor import (
    _anchor_refine,
    _anchor_refine_map,
    _pose_graph_refine,
    _refine_step,
)
from rspc_tpu_torch.registration.bufferops import (
    _as_unorganized,
    _rigid_inverse,
    merge_append,
)
from rspc_tpu_torch.registration.icp import icp_align
from rspc_tpu_torch.registration.ndt import (
    ndt_align,
    ndt_grid_from_moments,
    ndt_grid_init,
    ndt_grid_origin,
    ndt_grid_update_moments,
)
from rspc_tpu_torch.registration.pairsteps import _fine_step, _guarded


def _stack(clouds):
    """Stack same-capacity clouds along a new leading axis."""
    first = clouds[0]
    return type(first)(**{
        f.name: (None if getattr(first, f.name) is None
                 else torch.stack([getattr(c, f.name) for c in clouds]))
        for f in dataclasses.fields(first)
    })


def _prepare_full_down(oc: OrganizedCloud, normals, n_valid, leaf, cap,
                       dec=1, purity=0.0, color=False) -> Cloud:
    """The refine stage's cloud: integral-image normals on the organized
    frame, every ``dec``-th pixel per axis, voxel means; with ``color``
    also the voxel means of the intensity-gradient field (computed at
    full resolution, ``ops/colorgrad.py``) on ``Cloud.cgrad``."""
    xyz, rgb, valid, nrm = oc.xyz, oc.rgb, oc.valid & n_valid, normals
    cg = color_gradients(oc, normals, n_valid) if color else None
    if dec > 1:
        xyz, rgb, valid, nrm = (x[::dec, ::dec] for x in (xyz, rgb, valid, nrm))
        if cg is not None:
            cg = cg[::dec, ::dec]
    m = xyz.shape[0] * xyz.shape[1]
    flat = Cloud(xyz.reshape(m, 3), rgb.reshape(m, 3), valid.reshape(m),
                 normal=nrm.reshape(m, 3),
                 cgrad=None if cg is None else cg.reshape(m, 3))
    return voxel_downsample(flat, leaf, cap, min_normal_purity=purity)


def _phase1_prepare(frames, edge_cfg, leaf, cap, with_full, dec=1, purity=0.0,
                    color=False):
    """Phase 1 for all frames: stacked edge clouds ``[n, edge_cap]`` and,
    when ``with_full``, the stacked refine clouds ``[n, cap]``. Each Canny
    class's hysteresis is one batched call over the frames."""
    feats, normals, n_valid = extract_edge_features_batch(frames, edge_cfg)
    full = None
    if with_full:
        full = _stack([
            _prepare_full_down(oc, normals[i], n_valid[i], leaf, cap, dec, purity, color)
            for i, oc in enumerate(frames)
        ])
    return _stack(feats), full


def _chain_scan(edges_all: Cloud, full_all, guesses, use_ndt: bool, ndt_cfg,
                icp_cfg, refine_stages, leaf: float, voxel_cap: int,
                target_cap: int, refine_target_cap: int,
                coarse_guard_cap: float, refine_margin: float = 0.75,
                warm_start: bool = False, rescue_thresh: float = 0.0,
                rescue_cap: float = 0.1, rescue_iters: int = 8, group=None):
    """The frame chain over stacked edge clouds ``[n, edge_cap]``: per
    pair, the coarse stage from the guess (NDT against the incremental
    moment grid, or ICP against the accumulated target without its
    fitness sweep), the never-worsen guard, fine ICP on the accumulated
    edge target, the gated rescue when ``rescue_thresh`` > 0, the refine
    against the accumulated full clouds when ``full_all`` (stacked
    ``[n, full_cap]``) is given, then the gated merges.

    ``warm_start`` (constant-velocity prediction): each pair's guess is
    (previous achieved total) o (this pair's raw guess increment) o (the
    carried LOCAL correction), and the guard also scores the raw guess,
    the prediction with the ``_WARM_GUARD_MARGIN`` preference. The local
    correction comes from the full achieved pair transform and updates
    only where the fine ICP converged; the previous total updates for
    every pair (gating it froze the prediction at identity on
    edge-starved scenes, which converge 0/9 yet carry accurate totals:
    the JAX package measured three orders of magnitude off on
    ``low_texture``).

    ``group``: the coarse and fine solves run on this rank's shard of
    their source, taken after the single-rank prefix or stride, so the
    solved population is the single-rank one (see the module docstring)."""
    n = edges_all.valid.shape[0]
    refine = full_all is not None
    edges_down = [
        voxel_downsample(edges_all.map(lambda x: x[i]), leaf, voxel_cap)
        for i in range(n)
    ]
    target0 = edges_down[0]
    target = merge_append(
        Cloud.empty(target_cap, target0.device,
                    with_normal=target0.normal is not None,
                    with_cgrad=target0.cgrad is not None),
        target0,
    )
    if use_ndt:
        # the incremental dense grid: frame 0's moments, then each
        # converged frame's aligned edges added (moments are additive)
        origin = ndt_grid_origin(target0, ndt_cfg)
        moments = ndt_grid_update_moments(
            ndt_grid_init(origin, ndt_cfg).moments, origin, target0, ndt_cfg
        )
    if refine:
        target_full = merge_append(
            Cloud.empty(refine_target_cap, target0.device, with_normal=True,
                        with_cgrad=full_all.cgrad is not None),
            full_all.map(lambda x: x[0]),
        )
    if warm_start:
        # per-pair guess increments inv(G[i-1]) @ G[i] (G[-1] = identity):
        # the raw guesses are absolute frame -> frame-0 estimates
        rel_guesses = torch.cat([guesses[:1], _rigid_inverse(guesses[:-1]) @ guesses[1:]])
        prev_total = c_local = torch.eye(4, dtype=guesses.dtype, device=guesses.device)
    coarse_icp_cfg = dataclasses.replace(icp_cfg, compute_fitness=False)
    coarse_s, fine_s, ref_s, totals = [], [], [], []
    for i in range(1, n):
        edge_i, guess = edges_down[i], guesses[i - 1]
        raw_guess = guess
        if warm_start:
            rel_g = rel_guesses[i - 1]
            guess = prev_total @ rel_g @ c_local
        if use_ndt:
            grid = ndt_grid_from_moments(moments, origin, ndt_cfg)
            coarse = ndt_align(edge_i, grid, ndt_cfg, guess, group=group)
        else:
            coarse = icp_align(edge_i, target, coarse_icp_cfg, guess, group=group)
        coarse = _guarded(coarse, guess, edge_i, target, coarse_guard_cap,
                          raw_guess if warm_start else None)
        fine, _ = _fine_step(target, edge_i, coarse, icp_cfg, rescue_thresh, rescue_cap,
                             rescue_iters, group)
        total = fine.transform @ coarse.transform
        if refine:
            full_i = full_all.map(lambda x: x[i])
            ref, _, total = _refine_step(target_full, full_i, total,
                                         refine_stages, refine_margin)
            ref_s.append(ref)
        conv = fine.converged
        edge_total = apply_transform_cloud(total, edge_i)
        target = merge_append(target, edge_total, gate=conv)
        if use_ndt:
            moments = ndt_grid_update_moments(moments, origin, edge_total, ndt_cfg,
                                              gate=conv)
        if refine:
            target_full = merge_append(
                target_full, apply_transform_cloud(total, full_i), gate=conv
            )
        if warm_start:
            new_c = _rigid_inverse(rel_g) @ _rigid_inverse(prev_total) @ total
            c_local = torch.where(conv, new_c, c_local)
            prev_total = total
        coarse_s.append(coarse)
        fine_s.append(fine)
        totals.append(total)
    return {
        "target": target,
        "coarse": coarse_s,
        "fine": fine_s,
        "refine": ref_s,
        "totals": torch.stack(totals),
        "edges_down0": target0,
    }


def _anchor_stages(full_all: Cloud, totals, r):
    """The refinements after the chain, on stacked refine clouds ``[n,
    full_cap]``, as the enabled refine config ``r`` asks: the anchor against frame 0 or the
    progressive map (``r.anchor_mode``), then the pose graph. Returns
    (totals, accepted or None)."""
    accepted = None
    if r.anchor_to_first:
        if r.anchor_mode == "map":
            totals, accepted = _anchor_refine_map(
                full_all, totals, r.anchor_stages, r.map_accept_margin, r.gate_radius,
                r.gate_inlier_keep, r.gate_rmse_blowup,
            )
        else:
            totals, accepted = _anchor_refine(
                full_all.map(lambda x: x[0]), full_all.map(lambda x: x[1:]), totals,
                r.anchor_stages, 1.0, r.gate_radius, r.gate_inlier_keep,
                r.gate_rmse_blowup, max_points=r.anchor_max_points,
            )
    if r.pose_graph and totals.shape[0] >= 2:
        totals = _pose_graph_refine(full_all, totals, r.anchor_stages, r.pose_graph_skips,
                                    r.gate_radius, max_points=r.anchor_max_points)
    return totals, accepted


def _assemble_global(originals, totals, converged) -> Cloud:
    """The global cloud from per-frame originals (unorganized clouds) and
    their transforms into frame 0, each frame gated by ``converged``
    (frame 0 always kept)."""
    eye = torch.eye(4, dtype=totals.dtype, device=totals.device)
    all_t = torch.cat([eye[None], totals], dim=0)
    conv_all = torch.cat([torch.ones_like(converged[:1]), converged])
    moved = [apply_transform_cloud(all_t[i], c) for i, c in enumerate(originals)]
    return Cloud(
        xyz=torch.cat([m.xyz for m in moved], dim=0),
        rgb=torch.cat([m.rgb for m in moved], dim=0),
        valid=torch.cat([m.valid & conv_all[i] for i, m in enumerate(moved)], dim=0),
    )


def _registration_body(feats: Cloud, full, originals, guesses, config, use_ndt: bool,
                       group=None) -> dict:
    """Everything after phase 1 for one sequence (port of
    ``rspc_tpu/registration/chainscan.py::_registration_body``): the
    chain of ``_chain_scan`` on the stacked edge clouds ``feats`` ``[n,
    edge_cap]`` (the refine clouds ``full`` ``[n, cap]`` in the chain
    under ``refine.chain``), then the anchor and the pose graph
    (``_anchor_stages``) and the global cloud from the unorganized
    ``originals``, each frame merged where its fine ICP converged or the
    anchor accepted it. ``guesses`` are the ``[n-1, 4, 4]`` initial
    transforms; ``group`` shards the chain's pair solves only.

    Returns ``_chain_scan``'s dict with ``totals`` after the anchor and
    ``anchor_accepted`` (None without the anchor), ``features``,
    ``full_down`` and ``global``."""
    r = config.refine
    n = feats.valid.shape[0]
    out = _chain_scan(
        feats, full if (r.enabled and r.chain) else None, guesses, use_ndt,
        config.ndt, config.icp, r.stages, config.voxel.leaf_size,
        config.voxel.max_points, config.voxel.max_points * n, r.max_points * n,
        config.coarse_guard_cap, r.accept_margin, config.coarse_warm_start,
        config.rescue_inlier_frac, config.rescue_cap, config.rescue_iterations,
        group=group,
    )
    totals, accepted = out["totals"], None
    if r.enabled:
        totals, accepted = _anchor_stages(full, totals, r)
    merge_ok = torch.stack([f.converged for f in out["fine"]])
    if accepted is not None:
        # anchor-accepted frames are verified against frame 0: merged
        # even where the fine edge ICP did not converge
        merge_ok = merge_ok | accepted
    out.update({"totals": totals, "anchor_accepted": accepted, "features": feats,
                "full_down": full if r.enabled else None,
                "global": _assemble_global(originals, totals, merge_ok)})
    return out


def _registration_fused(frames, guesses, config, use_ndt: bool, group=None) -> dict:
    """One sequence's whole registration (port of
    ``rspc_tpu/registration/chainscan.py::_registration_fused``): phase 1
    on the organized ``frames`` (one shape), then
    :func:`_registration_body`. The JAX package compiles this as one
    program; here it is the same calls in the same order as the fused
    path of the edge schemes, so both give the same bits."""
    r = config.refine
    feats, full = _phase1_prepare(
        list(frames), config.edge, r.leaf_size, r.max_points, r.enabled, r.decimate,
        r.normal_purity, r.color,
    )
    return _registration_body(feats, full, [_as_unorganized(f) for f in frames],
                              guesses, config, use_ndt, group)
