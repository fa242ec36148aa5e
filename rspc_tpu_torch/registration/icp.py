"""ICP with PCL-parity convergence semantics (port of
``rspc_tpu/registration/icp.py``): NN correspondences -> weighted rigid
(point-to-point) or point-to-plane fit -> transform update -> PCL
``DefaultConvergenceCriteria`` in order (max iterations -> transform ->
absolute MSE -> relative MSE), with ``NO_CORRESPONDENCES`` aborting below
``min_number_correspondences``.

The JAX ``lax.while_loop`` becomes a Python loop whose stop test reads
one device bool per iteration (one host sync per ICP iteration). The
colored residual, ``point_plane_mix`` and the sharded (``psum_axis``)
form are not ported yet (ROADMAP.md Queue A).
"""

from __future__ import annotations

import dataclasses

import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.config import ICPConfig
from rspc_tpu_torch.ops.transform import apply_transform
from rspc_tpu_torch.ops.umeyama import _homogeneous, _rodrigues, plane_fit, rigid_fit
from rspc_tpu_torch.registration.bufferops import _stride_cloud
from rspc_tpu_torch.registration.measures import _nn_sweep

# pcl::registration::DefaultConvergenceCriteria::ConvergenceState
NOT_CONVERGED = 0
ITERATIONS = 1
TRANSFORM = 2
ABS_MSE = 3
REL_MSE = 4
NO_CORRESPONDENCES = 5


def _rotation_angle(t: torch.Tensor) -> torch.Tensor:
    cos = 0.5 * (t[..., 0, 0] + t[..., 1, 1] + t[..., 2, 2] - 1.0)
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def _scale_increment(t_inc: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Shrink a rigid increment toward identity by factor ``s`` in the
    log map (rotation angle and translation scale linearly)."""
    r = t_inc[..., :3, :3]
    ang = _rotation_angle(t_inc)
    skew = torch.stack(
        [r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
         r[..., 1, 0] - r[..., 0, 1]],
        dim=-1,
    )
    axis = skew / torch.clamp(2.0 * torch.sin(ang), min=1e-12)[..., None]
    omega = torch.where((ang > 1e-7)[..., None], (s * ang)[..., None] * axis, 0.0)
    return _homogeneous(_rodrigues(omega), s[..., None] * t_inc[..., :3, 3])


def _trust_region(t_inc, src_t, src_valid, max_corr_dist: float):
    """Scale back an increment that would move some point farther than
    2x the correspondence cap (extrapolating beyond the matches)."""
    ang = _rotation_angle(t_inc)
    mean_t = src_t.mean(dim=-2, keepdim=True)  # unmasked row mean
    span_sq = torch.where(src_valid, ((src_t - mean_t) ** 2).sum(-1), 0.0).amax(-1)
    move = ang * torch.sqrt(span_sq) + torch.linalg.vector_norm(
        t_inc[..., :3, 3], dim=-1
    )
    scale = torch.clamp(2.0 * max_corr_dist / torch.clamp(move, min=1e-12), max=1.0)
    return torch.where(
        (scale < 1.0)[..., None, None], _scale_increment(t_inc, scale), t_inc
    )


@dataclasses.dataclass(frozen=True)
class ICPResult:
    """``getFinalTransformation`` / ``hasConverged`` plus fitness/RMSE."""

    transform: torch.Tensor          # f32[4,4] (incl. guess)
    converged: torch.Tensor          # bool
    state: torch.Tensor              # i32 ConvergenceState
    iterations: torch.Tensor         # i32
    fitness: torch.Tensor            # f32 mean squared NN distance
    inlier_rmse: torch.Tensor        # f32
    n_correspondences: torch.Tensor  # i32


def icp_align(
    src: Cloud,
    tgt: Cloud,
    config: ICPConfig = ICPConfig(),
    init_guess: torch.Tensor | None = None,
) -> ICPResult:
    """Align ``src`` onto ``tgt`` (PCL ``icp.align(output, guess)``)."""
    if config.color_weight > 0.0 or config.point_plane_mix > 0.0:
        raise NotImplementedError(
            "colored ICP and point_plane_mix are not ported yet "
            "(ROADMAP.md Queue A)"
        )
    dev, dtype = src.xyz.device, src.xyz.dtype
    final_t = (torch.eye(4, dtype=dtype, device=dev) if init_guess is None
               else init_guess.to(dtype))
    src = _stride_cloud(src, config.max_source_points)
    p2l = config.variant == "point_to_plane"
    if p2l and tgt.normal is None:
        raise ValueError(
            "point_to_plane ICP needs a target cloud with normals "
            "(edge clouds carry them; see extract_edge_features)"
        )
    max_d2 = config.max_correspondence_distance**2
    rot_thresh = 1.0 - config.transformation_epsilon
    # prev_mse seed: PCL starts at +max; 1e18 keeps 1/prev normal (see
    # the JAX package) while dwarfing any real MSE
    prev_mse = torch.full((), 1e18, dtype=dtype, device=dev)

    def correspondences(t):
        src_t = apply_transform(t, src.xyz)
        d2, idx = _nn_sweep(src_t, src.valid, tgt.xyz, tgt.valid,
                            chunk=config.target_chunk)
        w = ((d2 <= max_d2) & src.valid & torch.isfinite(d2)).to(dtype)
        return src_t, d2, idx, w

    it = 0
    while True:
        src_t, d2, idx, w = correspondences(final_t)
        n_corr = w.sum()
        cur_mse = torch.where(w > 0, d2, 0.0).sum() / torch.clamp(n_corr, min=1.0)
        too_few = n_corr < config.min_number_correspondences
        tgt_m = tgt.xyz.index_select(0, idx.long())
        if p2l:
            tgt_n = tgt.normal.index_select(0, idx.long())
            w_fit = w
            if config.huber_delta is not None:
                r = ((src_t - tgt_m) * tgt_n).sum(-1)
                w_fit = w * torch.clamp(
                    config.huber_delta / torch.clamp(r.abs(), min=1e-12), max=1.0
                )
            t_inc = plane_fit(src_t, tgt_m, tgt_n, w_fit)
            t_inc = _trust_region(t_inc, src_t, src.valid,
                                  config.max_correspondence_distance)
        else:
            t_inc = rigid_fit(src_t, tgt_m, w)
        it += 1

        cos_angle = 0.5 * (t_inc[0, 0] + t_inc[1, 1] + t_inc[2, 2] - 1.0)
        t_sqr = (t_inc[:3, 3] ** 2).sum()
        hit_transform = (cos_angle >= rot_thresh) & (
            t_sqr <= config.transformation_epsilon
        )
        dmse = (cur_mse - prev_mse).abs()
        hit_abs = dmse < config.mse_threshold_absolute
        hit_rel = dmse / torch.clamp(prev_mse, min=1e-30) < config.euclidean_fitness_epsilon
        # PCL's order: too few > iterations > transform > abs > rel
        state = torch.where(hit_rel, REL_MSE, NOT_CONVERGED)
        state = torch.where(hit_abs, ABS_MSE, state)
        state = torch.where(hit_transform, TRANSFORM, state)
        if it >= config.max_iterations:
            state = torch.full_like(state, ITERATIONS)
        state = torch.where(too_few, NO_CORRESPONDENCES, state).to(torch.int32)
        # on a too-few abort PCL breaks before updating the transform
        final_t = torch.where(too_few, final_t, t_inc @ final_t)
        prev_mse = cur_mse
        if bool(state != NOT_CONVERGED):  # host sync: the loop's stop test
            break

    converged = (state != NOT_CONVERGED) & (state != NO_CORRESPONDENCES)
    nan = torch.full((), float("nan"), dtype=dtype, device=dev)
    if config.compute_fitness:
        # getFitnessScore(): mean squared NN distance at the final pose
        _, d2, _, w = correspondences(final_t)
        fin = torch.where(src.valid & torch.isfinite(d2), d2, 0.0)
        fitness = fin.sum() / torch.clamp(src.valid.to(dtype).sum(), min=1.0)
        n_inl = w.sum()
        inlier_rmse = torch.sqrt(
            torch.where(w > 0, d2, 0.0).sum() / torch.clamp(n_inl, min=1.0)
        )
    else:
        fitness, inlier_rmse = nan, nan
        n_inl = torch.zeros((), dtype=dtype, device=dev)
    return ICPResult(
        transform=final_t,
        converged=converged,
        state=state,
        iterations=torch.full((), it, dtype=torch.int32, device=dev),
        fitness=fitness,
        inlier_rmse=inlier_rmse,
        n_correspondences=n_inl.to(torch.int32),
    )
