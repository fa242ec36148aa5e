"""Per-pair steps of the edge schemes' loop path, the coarse stage's
never-worsen guard and the gated wide-cap rescue (port of
``rspc_tpu/registration/pairsteps.py``): the coarse -> fine pair programs
of both edge schemes (src/icp_edge_based_registration.hpp:41-52,
src/ndt_edge_based_registration.hpp:38-43) and the IMU guesses.

The rescue's gate (``lax.cond`` in the JAX package) is a branch on the
host: one sync per pair reads whether the fine-cap inlier fraction fell
below the threshold, and only then do the wide-cap solves run, so a
clean pair pays the test alone and not two extra ICP solves.
"""

from __future__ import annotations

import dataclasses

import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.ops.transform import (
    apply_transform,
    apply_transform_cloud,
    imu_guess_full,
    imu_guess_y,
    relative_thetas,
)
from rspc_tpu_torch.ops.voxel import voxel_downsample
from rspc_tpu_torch.registration.bufferops import _stride_cloud
from rspc_tpu_torch.registration.icp import icp_align
from rspc_tpu_torch.registration.measures import _capped_sum, _inlier_stats, _nn_sweep
from rspc_tpu_torch.registration.ndt import build_ndt_grid, ndt_align

# Preference multiplier for the constant-velocity prediction in the
# guard's vote: the prediction wins unless a competitor beats its capped
# score by >15% (an aliased coarse pose scores within ~10% of a good
# prediction on the partial-overlap chain; the JAX package records why).
_WARM_GUARD_MARGIN = 0.85

# Minimum fine-cap inlier-count growth for a fired rescue to be kept:
# noise firings measure ~1.0x, genuine local-optimum escapes 2-5x.
_RESCUE_KEEP_GAIN = 1.5

# Source-point budget for the guard's hypothesis sweep (same constant as
# the JAX package: a strided 4096-point subsample decides identically).
_GUARD_MAX_POINTS = 4096


def _guarded(coarse, guess, src_down: Cloud, target: Cloud, guard_cap: float,
             fallback=None):
    """``coarse`` with its transform put through the guard when
    ``guard_cap`` > 0: the coarse result against the guess it started
    from and, under the warm start, the raw ``fallback`` guess, the
    warmed guess scored with the ``_WARM_GUARD_MARGIN`` preference."""
    if guard_cap <= 0.0:
        return coarse
    hyps, w = [coarse.transform, guess], None
    if fallback is not None:
        hyps.append(fallback)
        w = (1.0, _WARM_GUARD_MARGIN, 1.0)
    return dataclasses.replace(coarse, transform=_guard_best(
        hyps, _stride_cloud(src_down, _GUARD_MAX_POINTS), target, guard_cap, w,
    ))


def _icp_pair_step(target: Cloud, edge: Cloud, guess, icp_cfg, leaf: float,
                   voxel_cap: int, guard_cap: float = 0.0, guard_fallback=None,
                   rescue_thresh: float = 0.0, rescue_cap: float = 0.1,
                   rescue_iters: int = 8):
    """One frame of the edge-ICP chain: downsample the source edges,
    coarse ICP from the guess (its fitness never read, so not computed),
    the guard (``guard_fallback``: the warm start's raw guess), fine ICP,
    the gated rescue when ``rescue_thresh`` > 0, compose. Returns
    (coarse, fine, the source edges moved by fine o coarse)."""
    src_down = voxel_downsample(edge, leaf, voxel_cap)
    coarse_cfg = dataclasses.replace(icp_cfg, compute_fitness=False)
    coarse = icp_align(src_down, target, coarse_cfg, guess)
    coarse = _guarded(coarse, guess, src_down, target, guard_cap, guard_fallback)
    return (coarse, *_fine_step(target, src_down, coarse, icp_cfg, rescue_thresh,
                                rescue_cap, rescue_iters))


def _ndt_pair_step(target: Cloud, edge: Cloud, guess, ndt_cfg, icp_cfg,
                   leaf: float, voxel_cap: int, guard_cap: float = 0.0,
                   guard_fallback=None, rescue_thresh: float = 0.0,
                   rescue_cap: float = 0.1, rescue_iters: int = 8):
    """One frame of the NDT chain: downsample, NDT coarse from the guess
    against a grid built from the whole accumulated target (its own
    bounding box, unlike the fused chain's incremental grid), the guard,
    fine ICP, the rescue, compose (src/ndt_edge_based_registration.hpp:66-108)."""
    src_down = voxel_downsample(edge, leaf, voxel_cap)
    coarse = ndt_align(src_down, build_ndt_grid(target, ndt_cfg), ndt_cfg, guess)
    coarse = _guarded(coarse, guess, src_down, target, guard_cap, guard_fallback)
    return (coarse, *_fine_step(target, src_down, coarse, icp_cfg, rescue_thresh,
                                rescue_cap, rescue_iters))


def _fine_step(target: Cloud, src_down: Cloud, coarse, icp_cfg, rescue_thresh,
               rescue_cap, rescue_iters, group=None):
    """Fine ICP from the coarse pose, then the gated rescue: (fine, the
    source moved by fine o coarse). With ``group`` the fine ICP is
    sharded over it; the rescue stays replicated, as in the JAX package."""
    aligned = apply_transform_cloud(coarse.transform, src_down)
    fine = icp_align(aligned, target, icp_cfg, group=group)
    return _maybe_rescue(fine, apply_transform_cloud(fine.transform, aligned), target,
                         icp_cfg, rescue_thresh, rescue_cap, rescue_iters)


def _imu_guesses(thetas: torch.Tensor, use_ndt: bool) -> torch.Tensor:
    """``[n-1, 4, 4]`` IMU initial guesses from ``[n, 3]`` thetas, rebased
    on frame 0: the NDT scheme's y-only mapping or the ICP scheme's full
    one."""
    guess_fn = imu_guess_y if use_ndt else imu_guess_full
    return guess_fn(relative_thetas(thetas)[1:])


def _guard_best(hypotheses, cloud: Cloud, tgt: Cloud, cap, weights=None):
    """The hypothesis transform with the best capped-NN score (earlier
    entries win ties). All hypotheses ride ONE NN sweep: the k transformed
    copies of the source are concatenated into a [kN] problem. The choice
    stays on the device (no host sync)."""
    k = len(hypotheses)
    stacked = torch.cat([apply_transform(t, cloud.xyz) for t in hypotheses], dim=0)
    valid = torch.cat([cloud.valid] * k, dim=0)
    d2, _ = _nn_sweep(stacked, valid, tgt.xyz, tgt.valid)
    scores, _ = _capped_sum(d2.reshape(k, -1), cloud.valid, cap)
    if weights is not None:
        # a weight < 1 gives that hypothesis a preference margin
        scores = scores * torch.tensor(weights, dtype=scores.dtype,
                                       device=scores.device)
    # index_select keeps the choice on the device (a tensor index would
    # read it back to the host)
    return torch.stack(hypotheses).index_select(0, torch.argmin(scores)[None])[0]


def _rescue_from(cur: Cloud, target: Cloud, n_inl, icp_cfg, cap: float, iters: int,
                 thresh: float):
    """Gated wide-cap rescue. ``cur`` is the source at the post-fine
    pose, ``n_inl`` its valid points with a correspondence inside the
    fine cap. When the inlier fraction is below ``thresh`` (read on the
    host: the one sync of the gate), run ``iters`` ICP iterations at the
    wider ``cap`` (the preset's own variant, huber and colored rows) and
    re-fine at the original cap; keep the result only if it does not
    worsen the capped-NN score AND grows the fine-cap inlier count by
    ``_RESCUE_KEEP_GAIN``. Returns (relative transform, fired bool)."""
    dtype = cur.xyz.dtype
    nv = cur.valid.to(dtype).sum()
    need = n_inl.to(dtype) / torch.clamp(nv, min=1.0) < thresh
    eye = torch.eye(4, dtype=dtype, device=cur.device)
    if not bool(need):  # host sync: the gate
        return eye, need
    wide_cfg = dataclasses.replace(
        icp_cfg, max_correspondence_distance=cap, max_iterations=iters,
        transformation_epsilon=1e-12, euclidean_fitness_epsilon=1e-12,
        compute_fitness=False,
    )
    r1 = icp_align(cur, target, wide_cfg)
    r2 = icp_align(apply_transform_cloud(r1.transform, cur), target,
                   dataclasses.replace(icp_cfg, compute_fitness=False))
    cand = r2.transform @ r1.transform
    # one [2N] sweep scores both hypotheses and counts both inlier sets
    both = torch.cat([apply_transform(cand, cur.xyz), cur.xyz], dim=0)
    d2, _ = _nn_sweep(both, torch.cat([cur.valid, cur.valid]), target.xyz, target.valid)
    d2 = d2.reshape(2, -1)
    s_cand, s_stay = _capped_sum(d2, cur.valid, cap)[0]
    fine_cap2 = icp_cfg.max_correspondence_distance ** 2
    n_cand, n_stay = (cur.valid & torch.isfinite(d2) & (d2 < fine_cap2)).to(dtype).sum(-1)
    keep = (s_cand <= s_stay) & (n_cand >= n_stay * _RESCUE_KEEP_GAIN)
    return torch.where(keep, cand, eye), need


def _maybe_rescue(fine, fine_aligned, target, icp_cfg, thresh, cap, iters):
    """Fold the gated rescue into a (fine result, aligned cloud) pair; a
    no-op when ``thresh`` is 0. The returned transform includes the
    correction; fitness and RMSE stay those of the pre-rescue pose."""
    if thresh <= 0.0:
        return fine, fine_aligned
    if icp_cfg.compute_fitness and icp_cfg.max_source_points <= 0:
        n_inl = fine.n_correspondences
    else:
        # a strided solve counts inliers over its subset; recount on the
        # full aligned cloud, which the gate normalizes by
        n_inl, _ = _inlier_stats(fine_aligned, target, icp_cfg.max_correspondence_distance)
    rel, _ = _rescue_from(fine_aligned, target, n_inl, icp_cfg, cap, iters, thresh)
    fine = dataclasses.replace(fine, transform=rel @ fine.transform)
    return fine, apply_transform_cloud(rel, fine_aligned)
