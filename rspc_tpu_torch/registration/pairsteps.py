"""Per-pair steps of the edge schemes' loop path and the coarse stage's
never-worsen guard (port of ``rspc_tpu/registration/pairsteps.py``): the
coarse -> fine pair programs of both edge schemes
(src/icp_edge_based_registration.hpp:41-52,
src/ndt_edge_based_registration.hpp:38-43) and the IMU guesses.

The warm start's fallback hypothesis and the wide-cap rescue stage raise
``NotImplementedError`` (ROADMAP.md Queue A: ``robust_config``).
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
from rspc_tpu_torch.registration.measures import _capped_sum, _nn_sweep
from rspc_tpu_torch.registration.ndt import build_ndt_grid, ndt_align

# Source-point budget for the guard's hypothesis sweep (same constant as
# the JAX package: a strided 4096-point subsample decides identically).
_GUARD_MAX_POINTS = 4096


def _refuse_robust(guard_fallback, rescue_thresh: float) -> None:
    if guard_fallback is not None or rescue_thresh > 0.0:
        raise NotImplementedError(
            "the warm start's fallback guess and the rescue stage are not "
            "ported yet (ROADMAP.md Queue A: robust_config)"
        )


def _guarded(coarse, guess, src_down: Cloud, target: Cloud, guard_cap: float):
    """``coarse`` with its transform put through the guard (the coarse
    result against the guess it started from), when ``guard_cap`` > 0."""
    if guard_cap <= 0.0:
        return coarse
    return dataclasses.replace(coarse, transform=_guard_best(
        [coarse.transform, guess], _stride_cloud(src_down, _GUARD_MAX_POINTS),
        target, guard_cap,
    ))


def _icp_pair_step(target: Cloud, edge: Cloud, guess, icp_cfg, leaf: float,
                   voxel_cap: int, guard_cap: float = 0.0, guard_fallback=None,
                   rescue_thresh: float = 0.0):
    """One frame of the edge-ICP chain: downsample the source edges,
    coarse ICP from the guess (its fitness never read, so not computed),
    the guard, fine ICP, compose. Returns (coarse, fine, the source
    edges moved by fine o coarse)."""
    _refuse_robust(guard_fallback, rescue_thresh)
    src_down = voxel_downsample(edge, leaf, voxel_cap)
    coarse_cfg = dataclasses.replace(icp_cfg, compute_fitness=False)
    coarse = icp_align(src_down, target, coarse_cfg, guess)
    coarse = _guarded(coarse, guess, src_down, target, guard_cap)
    aligned = apply_transform_cloud(coarse.transform, src_down)
    fine = icp_align(aligned, target, icp_cfg)
    return coarse, fine, apply_transform_cloud(fine.transform, aligned)


def _ndt_pair_step(target: Cloud, edge: Cloud, guess, ndt_cfg, icp_cfg,
                   leaf: float, voxel_cap: int, guard_cap: float = 0.0,
                   guard_fallback=None, rescue_thresh: float = 0.0):
    """One frame of the NDT chain: downsample, NDT coarse from the guess
    against a grid built from the whole accumulated target (its own
    bounding box, unlike the fused chain's incremental grid), the guard,
    fine ICP, compose (src/ndt_edge_based_registration.hpp:66-108)."""
    _refuse_robust(guard_fallback, rescue_thresh)
    src_down = voxel_downsample(edge, leaf, voxel_cap)
    coarse = ndt_align(src_down, build_ndt_grid(target, ndt_cfg), ndt_cfg, guess)
    coarse = _guarded(coarse, guess, src_down, target, guard_cap)
    aligned = apply_transform_cloud(coarse.transform, src_down)
    fine = icp_align(aligned, target, icp_cfg)
    return coarse, fine, apply_transform_cloud(fine.transform, aligned)


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
        scores = scores * torch.tensor(weights, dtype=scores.dtype,
                                       device=scores.device)
    # index_select keeps the choice on the device (a tensor index would
    # read it back to the host)
    return torch.stack(hypotheses).index_select(0, torch.argmin(scores)[None])[0]
