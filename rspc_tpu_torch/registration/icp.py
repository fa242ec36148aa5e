"""ICP with PCL-parity convergence semantics (port of
``rspc_tpu/registration/icp.py``): NN correspondences -> weighted rigid
(point-to-point) or point-to-plane fit -> transform update -> PCL
``DefaultConvergenceCriteria`` in order (max iterations -> transform ->
absolute MSE -> relative MSE), with ``NO_CORRESPONDENCES`` aborting below
``min_number_correspondences``.

The JAX ``lax.while_loop`` becomes a Python loop whose stop test reads
one device bool per iteration (one host sync per ICP iteration, the
tracer's wait ``icp_stop``). The
point-to-plane variant takes the colored-ICP rows (Park, Zhou, Koltun
2017) when the config's ``color_weight`` > 0 and the target carries
intensity gradients (``Cloud.cgrad``), and ``point_plane_mix``.

``group`` (the JAX ``psum_axis``): a process group over whose ranks the
source is sharded, the target replicated. Every rank passes the whole
source; the solver strides it to ``max_source_points`` as on one rank
and solves on this rank's chunk of the rows. Every source reduction (the
correspondence count and MSE, the fit moments, the trust region's mean
and span, the fitness sums) is all-reduced, so every rank takes the same
branches and returns the same global result (``parallel/``). With no
group nothing is reduced and the arithmetic is the single-rank one.
"""

from __future__ import annotations

import dataclasses

import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.config import ICPConfig
from rspc_tpu_torch.ops.collectives import pmax, psum, shard_cloud, shard_count
from rspc_tpu_torch.ops.colorgrad import intensity
from rspc_tpu_torch.ops.transform import apply_transform
from rspc_tpu_torch.ops.umeyama import _homogeneous, _rodrigues, plane_fit, rigid_fit
from rspc_tpu_torch.registration.bufferops import _stride_cloud
from rspc_tpu_torch.registration.measures import _nn_sweep
from rspc_tpu_torch.utils import profiling

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


def _trust_region(t_inc, src_t, src_valid, max_corr_dist: float, group=None):
    """Scale back an increment that would move some point farther than
    2x the correspondence cap (extrapolating beyond the matches). With
    ``group``, the mean is over every rank's rows (the shards hold equal
    row counts, padding included, as the JAX package counts them) and the
    span is the ranks' maximum."""
    ang = _rotation_angle(t_inc)
    mean_t = src_t.mean(dim=-2, keepdim=True)  # unmasked row mean
    if group is not None:
        mean_t = psum((mean_t,), group)[0] / shard_count(group)
    span_sq = torch.where(src_valid, ((src_t - mean_t) ** 2).sum(-1), 0.0).amax(-1)
    span_sq = pmax(span_sq, group)
    move = ang * torch.sqrt(span_sq) + torch.linalg.vector_norm(
        t_inc[..., :3, 3], dim=-1
    )
    scale = torch.clamp(2.0 * max_corr_dist / torch.clamp(move, min=1e-12), max=1.0)
    return torch.where(
        (scale < 1.0)[..., None, None], _scale_increment(t_inc, scale), t_inc
    )


def _pcl_state(t_inc, cur_mse, prev_mse, too_few, it: int, config: ICPConfig):
    """PCL ``DefaultConvergenceCriteria`` after iteration ``it`` (1-based),
    in PCL's order: too few > iterations > transform > abs > rel."""
    cos_angle = 0.5 * (t_inc[0, 0] + t_inc[1, 1] + t_inc[2, 2] - 1.0)
    t_sqr = (t_inc[:3, 3] ** 2).sum()
    hit_transform = (cos_angle >= 1.0 - config.transformation_epsilon) & (
        t_sqr <= config.transformation_epsilon
    )
    dmse = (cur_mse - prev_mse).abs()
    hit_abs = dmse < config.mse_threshold_absolute
    hit_rel = dmse / torch.clamp(prev_mse, min=1e-30) < config.euclidean_fitness_epsilon
    state = torch.where(hit_rel, REL_MSE, NOT_CONVERGED)
    state = torch.where(hit_abs, ABS_MSE, state)
    state = torch.where(hit_transform, TRANSFORM, state)
    if it >= config.max_iterations:
        state = torch.full_like(state, ITERATIONS)
    return torch.where(too_few, NO_CORRESPONDENCES, state).to(torch.int32)


def _huber(w, delta, residual):
    """``w`` times the Huber IRLS weight of ``residual()``; ``w`` itself
    when ``delta`` is None."""
    if delta is None:
        return w
    r = residual()
    return w * torch.clamp(delta / torch.clamp(r.abs(), min=1e-12), max=1.0)


def _intensities(src: Cloud, tgt: Cloud, config: ICPConfig):
    """(source, target) pose-invariant intensities for the colored rows,
    or (None, None) where the config or the target does not engage them."""
    if (config.variant == "point_to_plane" and config.color_weight > 0.0
            and tgt.cgrad is not None):
        dtype = src.xyz.dtype
        return intensity(src.rgb).to(dtype), intensity(tgt.rgb).to(dtype)
    return None, None


def _color_rows(src_t, tgt_m, idx, w, tgt: Cloud, i_src, i_tgt, config: ICPConfig):
    """The colored rows at correspondences ``idx``: (target intensity
    gradients, intensity residuals, weights from the raw mask ``w`` with
    their own Huber)."""
    g_m = tgt.cgrad.index_select(0, idx.long())
    di = i_tgt.index_select(0, idx.long()) - i_src
    w_c = _huber(w * config.color_weight, config.color_huber_delta,
                 lambda: ((src_t - tgt_m) * g_m).sum(-1) + di)
    return g_m, di, w_c


def _fitness_stats(src_valid, d2, w, group=None):
    """(fitness, inlier RMSE, inlier count) at the final pose: PCL's
    ``getFitnessScore`` (mean squared NN distance over valid sources) and
    the RMSE over the inliers ``w``, summed over ``group``'s shards."""
    dtype = d2.dtype
    fin = torch.where(src_valid & torch.isfinite(d2), d2, 0.0)
    fit_sum, nv, inl_sum, n_inl = psum(
        (fin.sum(), src_valid.to(dtype).sum(), torch.where(w > 0, d2, 0.0).sum(),
         w.sum()), group)
    fitness = fit_sum / torch.clamp(nv, min=1.0)
    return fitness, torch.sqrt(inl_sum / torch.clamp(n_inl, min=1.0)), n_inl


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
    group=None,
) -> ICPResult:
    """Align ``src`` onto ``tgt`` (PCL ``icp.align(output, guess)``).
    With ``group``, every rank passes the whole ``src`` and solves on its
    shard of the strided rows. Traced as the span ``icp.align`` (a pair's
    number is its order among its call's ``icp.align`` spans)."""
    with profiling.span("icp.align", sources=src.capacity, targets=tgt.capacity):
        return _align(src, tgt, config, init_guess, group)


def _align(src: Cloud, tgt: Cloud, config: ICPConfig, init_guess, group) -> ICPResult:
    dev, dtype = src.xyz.device, src.xyz.dtype
    final_t = (torch.eye(4, dtype=dtype, device=dev) if init_guess is None
               else init_guess.to(dtype))
    src = _stride_cloud(src, config.max_source_points)
    if group is not None:
        src = shard_cloud(src, group)
    p2l = config.variant == "point_to_plane"
    if p2l and tgt.normal is None:
        raise ValueError(
            "point_to_plane ICP needs a target cloud with normals "
            "(edge clouds carry them; see extract_edge_features)"
        )
    i_src, i_tgt = _intensities(src, tgt, config)
    max_d2 = config.max_correspondence_distance**2
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
    stop = False
    while not stop:
        with profiling.span("icp.iter"):
            src_t, d2, idx, w = correspondences(final_t)
            n_corr, mse_sum = psum((w.sum(), torch.where(w > 0, d2, 0.0).sum()), group)
            cur_mse = mse_sum / torch.clamp(n_corr, min=1.0)
            too_few = n_corr < config.min_number_correspondences
            with profiling.span("icp.fit"):
                tgt_m = tgt.xyz.index_select(0, idx.long())
                if p2l:
                    tgt_n = tgt.normal.index_select(0, idx.long())
                    w_fit = _huber(w, config.huber_delta,
                                   lambda: ((src_t - tgt_m) * tgt_n).sum(-1))
                    color_kw = {}
                    if i_src is not None:
                        g_m, di, w_c = _color_rows(src_t, tgt_m, idx, w, tgt, i_src, i_tgt,
                                                   config)
                        color_kw = dict(cgrad=g_m, color_resid=di, color_weights=w_c)
                    t_inc = plane_fit(src_t, tgt_m, tgt_n, w_fit,
                                      point_mix=config.point_plane_mix, group=group,
                                      **color_kw)
                    t_inc = _trust_region(t_inc, src_t, src.valid,
                                          config.max_correspondence_distance, group)
                else:
                    t_inc = rigid_fit(src_t, tgt_m, w, group)
            it += 1
            state = _pcl_state(t_inc, cur_mse, prev_mse, too_few, it, config)
            # on a too-few abort PCL breaks before updating the transform
            final_t = torch.where(too_few, final_t, t_inc @ final_t)
            prev_mse = cur_mse
            with profiling.wait("icp_stop"):
                stop = bool(state != NOT_CONVERGED)  # host sync: the loop's stop test

    converged = (state != NOT_CONVERGED) & (state != NO_CORRESPONDENCES)
    nan = torch.full((), float("nan"), dtype=dtype, device=dev)
    if config.compute_fitness:
        # getFitnessScore(): mean squared NN distance at the final pose
        _, d2, _, w = correspondences(final_t)
        fitness, inlier_rmse, n_inl = _fitness_stats(src.valid, d2, w, group)
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
