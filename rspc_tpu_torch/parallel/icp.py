"""Source-sharded ICP (port of ``rspc_tpu/parallel/icp.py``).

The source's rows are sharded over a mesh axis (each rank passes the
whole cloud and solves on its chunk), the target replicated. Every
iteration is the local NN sweep (kernel B1 on the card), the local fit
moments, one all-reduce over the axis's process group, and the same
solve and PCL convergence test on every rank:

  * point-to-point: the 16 moments of ``ops/umeyama.py::fit_moments``
    and the MSE sum, 17 scalars;
  * point-to-plane (and colored point-to-plane): the weighted centroid
    first (4 scalars), then the 6x6 system, the correspondence count and
    the MSE sum (44 scalars); the colored rows (Park, Zhou, Koltun 2017)
    fold into the same 6x6 moments.

As in the JAX package this loop is its own: no ``max_source_points``
stride, no trust region and no point-to-plane point mix
(``registration/icp.py`` has those, and its ``group`` argument is what
the sharded chain uses), and the fitness sweep always runs.
``batched_sharded_icp_align`` adds the ``data`` axis: a batch of pairs,
each rank solving its share and every rank getting the whole result.
"""

from __future__ import annotations

import dataclasses

import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.config import ICPConfig
from rspc_tpu_torch.ops.collectives import (
    gather_rows,
    psum,
    shard_cloud,
    shard_count,
    shard_index,
    shard_rows,
)
from rspc_tpu_torch.ops.transform import apply_transform
from rspc_tpu_torch.ops.umeyama import (
    _homogeneous,
    fit_moments,
    plane_fit_from_moments,
    plane_fit_moments,
    rigid_fit_from_moments,
)
from rspc_tpu_torch.registration.icp import (
    NO_CORRESPONDENCES,
    NOT_CONVERGED,
    ICPResult,
    _color_rows,
    _fitness_stats,
    _huber,
    _intensities,
    _pcl_state,
)
from rspc_tpu_torch.registration.measures import _nn_sweep


def _local_icp(src: Cloud, s_int, tgt: Cloud, t_int, guess, config: ICPConfig,
               group) -> ICPResult:
    """One pair's solve on this rank's source shard ``src`` (and its
    intensities ``s_int`` for the colored rows) against the replicated
    ``tgt``; the moments are all-reduced over ``group``."""
    dev, dtype = src.xyz.device, src.xyz.dtype
    max_d2 = config.max_correspondence_distance**2
    p2l = config.variant == "point_to_plane"

    def correspondences(t):
        src_t = apply_transform(t, src.xyz)
        d2, idx = _nn_sweep(src_t, src.valid, tgt.xyz, tgt.valid,
                            chunk=config.target_chunk)
        w = ((d2 <= max_d2) & src.valid & torch.isfinite(d2)).to(dtype)
        return src_t, d2, idx, w

    final_t = guess
    prev_mse = torch.full((), 1e18, dtype=dtype, device=dev)
    it = 0
    while True:
        src_t, d2, idx, w = correspondences(final_t)
        tgt_m = tgt.xyz.index_select(0, idx.long())
        mse_sum = torch.where(w > 0, d2, 0.0).sum()
        if p2l:
            tgt_n = tgt.normal.index_select(0, idx.long())
            w_fit = _huber(w, config.huber_delta, lambda: ((src_t - tgt_m) * tgt_n).sum(-1))
            # the global weighted centroid for the conditioning shift
            sw_c, sc = psum((w_fit.sum(), (src_t * w_fit[:, None]).sum(0)), group)
            c = sc / torch.clamp(sw_c, min=1e-12)
            h6, g6 = plane_fit_moments(src_t - c, tgt_m - c, tgt_n, w_fit)
            if s_int is not None:
                g_m, di, w_col = _color_rows(src_t, tgt_m, idx, w, tgt, s_int, t_int, config)
                hc, gc = plane_fit_moments(src_t - c, tgt_m - c, g_m, w_col, offset=di)
                h6, g6 = h6 + hc, g6 + gc
            h6, g6, n_corr, mse_sum = psum((h6, g6, w.sum(), mse_sum), group)
            t_c = plane_fit_from_moments(h6, g6)
            rot = t_c[:3, :3]
            t_inc = _homogeneous(rot, t_c[:3, 3] + c - rot @ c)
        else:
            sw, ss, sd, m, mse_sum = psum((*fit_moments(src_t, tgt_m, w), mse_sum), group)
            n_corr = sw
            t_inc = rigid_fit_from_moments(sw, ss, sd, m)
        cur_mse = mse_sum / torch.clamp(n_corr, min=1.0)
        too_few = n_corr < config.min_number_correspondences
        it += 1
        state = _pcl_state(t_inc, cur_mse, prev_mse, too_few, it, config)
        final_t = torch.where(too_few, final_t, t_inc @ final_t)
        prev_mse = cur_mse
        if bool(state != NOT_CONVERGED):  # host sync, the same on every rank
            break

    _, d2, _, w = correspondences(final_t)
    fitness, inlier_rmse, n_inl = _fitness_stats(src.valid, d2, w, group)
    return ICPResult(
        transform=final_t,
        converged=(state != NOT_CONVERGED) & (state != NO_CORRESPONDENCES),
        state=state,
        iterations=torch.full((), it, dtype=torch.int32, device=dev),
        fitness=fitness,
        inlier_rmse=inlier_rmse,
        n_correspondences=n_inl.to(torch.int32),
    )


def _color_inputs(src: Cloud, tgt: Cloud, config: ICPConfig):
    """(source intensities, target intensities) for the colored rows, or
    (None, None) when the config does not engage them; unlike one rank's
    ``icp_align``, a colored config needs the target's ``cgrad``."""
    if (config.variant == "point_to_plane" and config.color_weight > 0.0
            and tgt.cgrad is None):
        raise ValueError(
            "color_weight > 0 needs a target cloud carrying cgrad "
            "(ops/colorgrad.py; EdgeConfig.carry_cgrad)"
        )
    return _intensities(src, tgt, config)


def _check_normals(tgt: Cloud, config: ICPConfig) -> None:
    if config.variant == "point_to_plane" and tgt.normal is None:
        raise ValueError("point_to_plane needs a target cloud with normals")


def sharded_icp_align(src: Cloud, tgt: Cloud, mesh, config: ICPConfig = ICPConfig(),
                      init_guess: torch.Tensor | None = None,
                      axis: str = "points") -> ICPResult:
    """Align ``src`` onto ``tgt`` with the source's rows sharded over the
    mesh axis ``axis`` (padded with invalid rows to a multiple of its
    size). Every rank passes the whole clouds and gets the same result,
    the single-rank solve's up to the order of the sums."""
    _check_normals(tgt, config)
    group = mesh.get_group(axis)
    guess = (torch.eye(4, dtype=src.xyz.dtype, device=src.device) if init_guess is None
             else init_guess.to(src.xyz.dtype))
    s_int, t_int = _color_inputs(src, tgt, config)
    if s_int is not None:
        s_int = shard_rows(s_int, group)
    return _local_icp(shard_cloud(src, group), s_int, tgt, t_int, guess, config, group)


def batched_sharded_icp_align(src: Cloud, tgt: Cloud, guesses: torch.Tensor, mesh,
                              config: ICPConfig = ICPConfig(), data_axis: str = "data",
                              points_axis: str = "points") -> ICPResult:
    """A batch of pairs (``src``/``tgt`` fields ``[B, N, ...]``,
    ``guesses`` ``[B, 4, 4]``): the batch sharded over ``data_axis`` (B
    must divide by its size), each pair's source rows over
    ``points_axis``. Every rank gets the whole ``[B]`` result."""
    _check_normals(tgt, config)
    b = src.xyz.shape[0]
    data = mesh.get_group(data_axis)
    points = mesh.get_group(points_axis)
    d = shard_count(data)
    if b % d:
        raise ValueError(f"batch {b} not divisible by the '{data_axis}' axis size {d}")
    s_int, t_int = _color_inputs(src, tgt, config)
    k = b // d
    mine = range(shard_index(data) * k, (shard_index(data) + 1) * k)
    results = []
    for i in mine:
        pick = lambda x, i=i: x[i]
        src_i, tgt_i = src.map(pick), tgt.map(pick)
        s_i = None if s_int is None else shard_rows(s_int[i], points)
        t_i = None if t_int is None else t_int[i]
        results.append(_local_icp(shard_cloud(src_i, points), s_i, tgt_i, t_i,
                                  guesses[i].to(src.xyz.dtype), config, points))
    return ICPResult(**{
        f.name: gather_rows(torch.stack([getattr(r, f.name) for r in results]), b, data)
        for f in dataclasses.fields(ICPResult)
    })
