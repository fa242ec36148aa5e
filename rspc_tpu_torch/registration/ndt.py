"""Normal Distributions Transform registration (port of
``rspc_tpu/registration/ndt.py``, Magnusson 2009 / PCL
``NormalDistributionsTransform`` semantics).

The target lives in a DENSE, INCREMENTAL ``[D^3]`` voxel grid of raw
corner-residual moments (each frame added as one per-cell segment sum,
``ndt_grid_add``); cells are finalized into means and eigenvalue-inflated
inverse covariances with the batched Jacobi ``eigh3``. The objective
uses the widened-table gather (one row gather per point per Newton
iteration, neighbourhood frozen for the derivatives and the line search)
or, with a positive resolved ``sweep_cells``, the dense compact-cell
sweep (``_compact_cells``: the valid cells compacted once per align,
every point scored against all of them under an adjacency mask);
single-pass analytic gradient and Hessian through a 10x10 gram matmul,
and the closed-form first and second derivatives of
``R = Rx(a) Ry(b) Rz(c)`` in place of ``jacfwd``.

The Newton ``while_loop`` and the line searches become Python loops;
each stop test reads one device bool. The default line search
(``_more_thuente``, the JAX package's frozen-neighbourhood safeguarded
bisection) and ``pcl_exact_line_search`` (``_more_thuente_exact``, PCL's
``computeStepLengthMT``, the neighbourhood refreshed at every trial)
each cost one host sync per trial, and the Newton loop one per
iteration. ``sweep_cells=-1`` (auto) resolves as in the JAX package: 512
cells for the 27-cell neighbourhood, the exact gather path for the 7-
and 1-cell ones. ``group`` (the JAX ``psum_axis``) shards the source
over a process group's ranks, the grid replicated: the score, its
gradient and Hessian are additive over source points, so each
evaluation ends in one all-reduce of at most 43 scalars and every rank
runs the same Newton steps and line-search trials (``parallel/ndt.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.config import NDTConfig
from rspc_tpu_torch.ops.collectives import psum, shard_cloud
from rspc_tpu_torch.ops.eig3 import eigh3
from rspc_tpu_torch.ops.transform import apply_transform, rotation_matrix
from rspc_tpu_torch.ops.umeyama import _homogeneous


@dataclasses.dataclass(frozen=True)
class NDTGrid:
    """Dense voxel-Gaussian grid; ``moments`` per cell is
    [count, sum_r(3), sum_rr^T(9)] with r the residual to the cell corner."""

    moments: torch.Tensor   # f32[D^3, 13]
    means: torch.Tensor     # f32[D^3, 3]
    inv_covs: torch.Tensor  # f32[D^3, 3, 3]
    valid: torch.Tensor     # bool[D^3]
    origin: torch.Tensor    # i32[3] cell coords of cell (0,0,0)


@dataclasses.dataclass(frozen=True)
class NDTResult:
    transform: torch.Tensor          # f32[4,4] (incl. guess)
    converged: torch.Tensor          # bool
    iterations: torch.Tensor         # i32
    score: torch.Tensor              # f32 summed NDT score
    trans_probability: torch.Tensor  # f32 score / n_points


def ndt_grid_origin(cloud: Cloud, config: NDTConfig) -> torch.Tensor:
    """The occupied bounding box's min cell, centred so the [D^3] span
    has symmetric headroom for frames added later."""
    d = config.dense_grid_dim
    coords = torch.floor(cloud.xyz / config.resolution).to(torch.int32)
    big = 2**20
    cmin = torch.where(cloud.valid[:, None], coords, big).amin(dim=0)
    cmax = torch.where(cloud.valid[:, None], coords, -big).amax(dim=0)
    empty = cmin == big
    cmin = torch.where(empty, 0, cmin)
    cmax = torch.where(empty, 0, cmax)
    margin = torch.clamp((d - (cmax - cmin + 1)) // 2, min=0)
    return cmin - margin


def ndt_grid_init(origin: torch.Tensor, config: NDTConfig = NDTConfig()) -> NDTGrid:
    c = config.dense_grid_dim**3
    dev = origin.device
    return NDTGrid(
        moments=torch.zeros((c, 13), device=dev),
        means=torch.zeros((c, 3), device=dev),
        inv_covs=torch.zeros((c, 3, 3), device=dev),
        valid=torch.zeros((c,), dtype=torch.bool, device=dev),
        origin=origin.to(torch.int32),
    )


def _finalize(moments: torch.Tensor, origin: torch.Tensor, config: NDTConfig):
    """(means, inv_covs, valid) from raw cell moments: sample covariance
    (n-1), cells below ``min_points_per_voxel`` dropped, eigenvalues
    floored at 0.01 * lambda_max."""
    d = config.dense_grid_dim
    res = config.resolution
    counts = moments[:, 0]
    cnt = torch.clamp(counts, min=1.0)
    mu_r = moments[:, 1:4] / cnt[:, None]
    sq = moments[:, 4:13].reshape(-1, 3, 3)
    cov = (sq - cnt[:, None, None] * mu_r[:, :, None] * mu_r[:, None, :]) / (
        torch.clamp(counts - 1.0, min=1.0)[:, None, None]
    )
    ok = counts >= config.min_points_per_voxel
    cells = torch.arange(d**3, dtype=torch.int32, device=moments.device)
    cell_coords = torch.stack([cells // (d * d), (cells // d) % d, cells % d], dim=-1)
    corner = (cell_coords + origin[None, :]).to(torch.float32) * res
    means = corner + mu_r
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    evals, evecs = eigh3(torch.where(ok[:, None, None], cov, eye))
    floor = 0.01 * evals[:, 2]
    evals_inf = torch.clamp(torch.maximum(evals, floor[:, None]), min=1e-12)
    inv_cov = torch.einsum("vij,vj,vkj->vik", evecs, 1.0 / evals_inf, evecs)
    return (
        torch.where(ok[:, None], means, 0.0),
        torch.where(ok[:, None, None], inv_cov, 0.0),
        ok,
    )


def ndt_grid_update_moments(
    moments: torch.Tensor,
    origin: torch.Tensor,
    cloud: Cloud,
    config: NDTConfig = NDTConfig(),
    gate=None,
) -> torch.Tensor:
    """Add a cloud's [count, r, r r^T] rows into the raw cell moments
    (returns a new tensor). Points outside the [D^3] span are dropped;
    ``gate`` (bool tensor) False adds nothing, with no host sync.

    The rows are summed per cell in ascending row order (a stable sort by
    cell, then a segment sum) and added to the moments: on the card a
    scatter-add (``index_add``) adds with float atomics in an order that
    changes from run to run, and NDT under ``PipelineConfig()`` turns
    those last bits into a registration that does not repeat itself."""
    res = config.resolution
    d = config.dense_grid_dim
    valid = cloud.valid if gate is None else cloud.valid & gate
    coords = torch.floor(cloud.xyz / res).to(torch.int32)
    rel = coords - origin[None, :]
    in_b = valid & ((rel >= 0) & (rel < d)).all(dim=-1)
    flat = torch.where(in_b, (rel[:, 0] * d + rel[:, 1]) * d + rel[:, 2], 0)
    r = cloud.xyz - coords.to(cloud.xyz.dtype) * res
    rr = (r[:, :, None] * r[:, None, :]).reshape(-1, 9)
    upd = torch.cat([torch.ones_like(r[:, :1]), r, rr], dim=-1)
    upd = torch.where(in_b[:, None], upd, 0.0)  # dropped rows add zeros
    cell, order = torch.sort(flat.long(), stable=True)
    bounds = torch.searchsorted(cell, torch.arange(d**3 + 1, device=cell.device))
    sums = torch.segment_reduce(upd.index_select(0, order), "sum",
                                lengths=bounds[1:] - bounds[:-1], axis=0)
    return moments + sums


def ndt_grid_from_moments(
    moments: torch.Tensor, origin: torch.Tensor, config: NDTConfig = NDTConfig()
) -> NDTGrid:
    means, inv_covs, ok = _finalize(moments, origin, config)
    return NDTGrid(moments=moments, means=means, inv_covs=inv_covs, valid=ok,
                   origin=origin)


def ndt_grid_add(grid: NDTGrid, cloud: Cloud, config: NDTConfig = NDTConfig()) -> NDTGrid:
    """Accumulate a cloud's points into the grid and re-finalize."""
    moments = ndt_grid_update_moments(grid.moments, grid.origin, cloud, config)
    return ndt_grid_from_moments(moments, grid.origin, config)


def build_ndt_grid(target: Cloud, config: NDTConfig = NDTConfig()) -> NDTGrid:
    """One-shot grid: origin from the cloud's own bounding box."""
    origin = ndt_grid_origin(target, config)
    return ndt_grid_add(ndt_grid_init(origin, config), target, config)


def _gauss_coeffs(config: NDTConfig):
    c1 = 10.0 * (1.0 - config.outlier_ratio)
    c2 = config.outlier_ratio / (config.resolution**3)
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
    return d1, d2


def _pose_to_matrix(p: torch.Tensor) -> torch.Tensor:
    """T = Trans(p[:3]) @ Rx(p3) @ Ry(p4) @ Rz(p5) (PCL convertTransform)."""
    r = rotation_matrix(p[3], 0) @ rotation_matrix(p[4], 1) @ rotation_matrix(p[5], 2)
    return _homogeneous(r, p[:3])


def _matrix_to_pose(t: torch.Tensor) -> torch.Tensor:
    """Euler extraction for R = Rx(a)Ry(b)Rz(c) (principal branch)."""
    r = t[:3, :3]
    b = torch.arcsin(torch.clamp(r[0, 2], -1.0, 1.0))
    c = torch.atan2(-r[0, 1], r[0, 0])
    a = torch.atan2(-r[1, 2], r[2, 2])
    return torch.cat([t[:3, 3], torch.stack([a, b, c])])


def _rot_factors(ang: torch.Tensor):
    """[(R, R', R'') of Rx(a), Ry(b), Rz(c)] in closed form."""
    out = []
    for axis in range(3):
        c, s = torch.cos(ang[axis]), torch.sin(ang[axis])
        z, o = torch.zeros_like(c), torch.ones_like(c)
        if axis == 0:
            m = [[o, z, z], [z, c, -s], [z, s, c]]
            d1 = [[z, z, z], [z, -s, -c], [z, c, -s]]
            d2 = [[z, z, z], [z, -c, s], [z, -s, -c]]
        elif axis == 1:
            m = [[c, z, s], [z, o, z], [-s, z, c]]
            d1 = [[-s, z, c], [z, z, z], [-c, z, -s]]
            d2 = [[-c, z, -s], [z, z, z], [s, z, -c]]
        else:
            m = [[c, -s, z], [s, c, z], [z, z, o]]
            d1 = [[-s, -c, z], [c, -s, z], [z, z, z]]
            d2 = [[-c, s, z], [-s, -c, z], [z, z, z]]
        mk = lambda rows: torch.stack([torch.stack(r) for r in rows])
        out.append((mk(m), mk(d1), mk(d2)))
    return out


def _rotation_derivatives(ang: torch.Tensor):
    """dR [3,3,3] (last axis = angle) and d2R [3,3,3,3] of
    R = Rx(a) Ry(b) Rz(c): the tensors ``jax.jacfwd`` gives the JAX
    package, in closed form."""
    f = _rot_factors(ang)

    def prod(orders):
        return f[0][orders[0]] @ f[1][orders[1]] @ f[2][orders[2]]

    first = [prod([1 if k == i else 0 for k in range(3)]) for i in range(3)]
    dr = torch.stack(first, dim=-1)
    second = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            orders = [0, 0, 0]
            orders[i] += 1
            orders[j] += 1
            second[i][j] = prod(orders)
    ddr = torch.stack([torch.stack(row, dim=-1) for row in second], dim=-2)
    return dr, ddr


_SYM = np.asarray(((0, 1, 2), (1, 3, 4), (2, 4, 5)))  # (i,j) -> unique slot


def _neighborhood_offsets(k: int) -> np.ndarray:
    if k == 27:
        return np.stack(
            np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), np.arange(-1, 2),
                        indexing="ij"),
            axis=-1,
        ).reshape(27, 3).astype(np.int32)
    if k == 7:
        return np.asarray(
            [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
             [0, 0, 1], [0, 0, -1]], np.int32)
    if k == 1:
        return np.zeros((1, 3), np.int32)
    raise ValueError("neighborhood must be 27, 7, or 1")


def _resolve_sweep_cells(config: NDTConfig) -> int:
    """``sweep_cells`` with -1 (auto) resolved as the JAX package does:
    512 compact cells for the 27-cell neighbourhood, else 0 (the exact
    gather path)."""
    if config.sweep_cells >= 0:
        return config.sweep_cells
    return 512 if config.neighborhood == 27 else 0


def _compact_cells(grid: NDTGrid, config: NDTConfig):
    """The grid's VALID cells (typically a few hundred of D^3) compacted
    into ``[C]``-row tables for the dense sweep, C the resolved
    ``sweep_cells``: (means [C,3], inverse-covariance unique components
    [C,6], valid [C], grid-relative cell coords i32[C,3]).

    Mask equivalence with the gather path: the sweep scores point n
    against compact cell c when ``adjacency(rel0_n, cellco_c) & within
    radius & cell valid``; the gather path scores (n, offset j) when
    ``in_bounds(rel0_n + off_j) & cell valid & within radius``. For every
    in-bounds neighbour the two enumerate the same (point, cell) pairs:
    adjacency(rel0, co) holds iff co = rel0 + off_j for some offset j of
    the neighbourhood, and a compact cell is an in-bounds cell. So the
    two paths are the same masked sum in another reduction order. The
    sort is stable (valid cells first, each class in cell-index order),
    so the compacted order, and with it the order of the sums, is the
    JAX package's. Valid cells beyond the cap are dropped."""
    d = config.dense_grid_dim
    order = torch.argsort((~grid.valid).to(torch.uint8), stable=True)
    sel = order[:_resolve_sweep_cells(config)]
    icg = grid.inv_covs.index_select(0, sel)
    ic6 = torch.stack([icg[:, 0, 0], icg[:, 0, 1], icg[:, 0, 2],
                       icg[:, 1, 1], icg[:, 1, 2], icg[:, 2, 2]], dim=-1)
    cellco = torch.stack([sel // (d * d), (sel // d) % d, sel % d], dim=-1).to(torch.int32)
    return grid.means.index_select(0, sel), ic6, grid.valid.index_select(0, sel), cellco


def _make_objective(src: Cloud, grid: NDTGrid, config: NDTConfig, group=None):
    """Returns (objective, lookup, fixed_objective, fixed_value_grad,
    fixed_value_grad_hess) with the JAX package's contracts: f(p) =
    -score(p), minimized by Newton; ``lookup(p)`` freezes the
    neighbourhood at pose p (per-point rows ``[N,k]`` from the gather
    path, or the compact tables ``[C]`` and an ``[N,C]`` mask from the
    dense sweep). With ``group`` every value, gradient and Hessian is
    summed over its ranks' source shards."""
    d1, d2 = _gauss_coeffs(config)
    res = config.resolution
    xyz, valid = src.xyz, src.valid
    dev = xyz.device
    w_src = valid.to(xyz.dtype)
    offs_np = _neighborhood_offsets(config.neighborhood)
    offs = torch.from_numpy(offs_np).to(dev)
    k = offs.shape[0]
    d = config.dense_grid_dim
    sym = torch.from_numpy(_SYM).to(dev)

    if _resolve_sweep_cells(config) > 0:
        mu_cells, ic6_cells, valid_cells, cellco = _compact_cells(grid, config)

        def lookup(p):
            """The loop-invariant compact tables and the [N,C] mask at
            pose p: no gather in the Newton loop."""
            pts = apply_transform(_pose_to_matrix(p), xyz)
            rel0 = torch.floor(pts / res).to(torch.int32) - grid.origin
            diff = (cellco[None, :, :] - rel0[:, None, :]).abs()  # [N,C,3]
            if config.neighborhood == 27:
                adj = (diff <= 1).all(dim=-1)
            elif config.neighborhood == 7:
                adj = diff.sum(dim=-1) <= 1
            else:
                adj = (diff == 0).all(dim=-1)
            x = pts[:, None, :] - mu_cells[None, :, :]
            within = (x * x).sum(-1) <= res * res
            mask = (adj & within & valid_cells[None, :]).to(xyz.dtype) * w_src[:, None]
            return mu_cells, ic6_cells, mask
    else:
        # Per-cell stats packed into one [G,10] row (mean, 6 unique
        # inverse covariance components, validity), widened so that
        # column block j holds the row of the cell at flat offset j: one
        # row gather per point per Newton iteration. The roll's
        # wraparound aliases rows only where a per-axis bound is
        # crossed, and in_b masks exactly those.
        icg = grid.inv_covs
        packed = torch.cat(
            [grid.means, icg[:, 0, 0:3], icg[:, 1, 1:3], icg[:, 2, 2:3],
             grid.valid.to(xyz.dtype)[:, None]],
            dim=1,
        )
        g_cells = d * d * d
        flat_offs = [int((o[0] * d + o[1]) * d + o[2]) for o in offs_np]
        wide = torch.cat([torch.roll(packed, -f, dims=0) for f in flat_offs], dim=1)

        def lookup(p):
            pts = apply_transform(_pose_to_matrix(p), xyz)
            rel0 = torch.floor(pts / res).to(torch.int32) - grid.origin
            rel = rel0[:, None, :] + offs[None, :, :]
            in_b = ((rel >= 0) & (rel < d)).all(dim=-1)
            base = torch.remainder((rel0[:, 0] * d + rel0[:, 1]) * d + rel0[:, 2], g_cells)
            row = wide.index_select(0, base.long()).reshape(-1, k, 10)
            mu = row[..., 0:3]
            ic6 = row[..., 3:9]
            hit = in_b & (row[..., 9] > 0.5)
            x = pts[:, None, :] - mu
            within = (x * x).sum(-1) <= res * res  # radiusSearch(res)
            mask = (hit & within).to(xyz.dtype) * w_src[:, None]
            return mu, ic6, mask

    def _common(p, mu, ic6, mask):
        pts = apply_transform(_pose_to_matrix(p), xyz)
        e = pts[:, None, :] - mu
        e0, e1, e2 = e[..., 0], e[..., 1], e[..., 2]
        i00, i01, i02 = ic6[..., 0], ic6[..., 1], ic6[..., 2]
        i11, i12, i22 = ic6[..., 3], ic6[..., 4], ic6[..., 5]
        be0 = i00 * e0 + i01 * e1 + i02 * e2
        be1 = i01 * e0 + i11 * e1 + i12 * e2
        be2 = i02 * e0 + i12 * e1 + i22 * e2
        q = e0 * be0 + e1 * be1 + e2 * be2
        expt = torch.exp(-0.5 * d2 * q) * mask
        return (be0, be1, be2), (i00, i01, i02, i11, i12, i22), expt

    def _basis(quadratic):
        x0, x1, x2 = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        cols = [torch.ones_like(x0), x0, x1, x2]
        if quadratic:
            cols += [x0 * x0, x0 * x1, x0 * x2, x1 * x1, x1 * x2, x2 * x2]
        return torch.stack(cols, dim=-1)

    def _value(ch0):
        """-score from the per-point channel ``ch0`` = ``expt.sum(-1)``:
        its dot with the basis' constant column, the product that gives
        the JAX package's gram matrix its ``[0, 0]``, taken alone so that
        all three evaluations round one sum alike. The line search's
        ``f_res < phi0`` compares values from two of them, and near the
        optimum the decrease falls below one ulp of the sum."""
        return d1 * torch.dot(ch0, torch.ones_like(ch0))

    def fixed_objective(p, mu, ic6, mask):
        _, _, expt = _common(p, mu, ic6, mask)
        return psum((_value(expt.sum(-1)),), group)[0]

    def fixed_value_grad(p, mu, ic6, mask):
        (be0, be1, be2), _, expt = _common(p, mu, ic6, mask)
        w = d1 * d2 * expt
        ch = torch.stack([expt.sum(-1), (w * be0).sum(-1), (w * be1).sum(-1),
                          (w * be2).sum(-1)])  # [4,N]
        mm = ch @ _basis(False)
        f = _value(ch[0])
        g_t = -mm[1:4, 0]
        m = -mm[1:4, 1:4]
        dr, _ = _rotation_derivatives(p[3:6])
        g_a = torch.einsum("ija,ij->a", dr, m)
        return psum((f, torch.cat([g_t, g_a])), group)

    def fixed_value_grad_hess(p, mu, ic6, mask):
        (be0, be1, be2), ii, expt = _common(p, mu, ic6, mask)
        i00, i01, i02, i11, i12, i22 = ii
        w = d1 * d2 * expt
        chans = (
            expt, w * be0, w * be1, w * be2,
            w * (d2 * be0 * be0 - i00), w * (d2 * be0 * be1 - i01),
            w * (d2 * be0 * be2 - i02), w * (d2 * be1 * be1 - i11),
            w * (d2 * be1 * be2 - i12), w * (d2 * be2 * be2 - i22),
        )
        ch = torch.stack([c.sum(-1) for c in chans])  # [10,N]
        mm = ch @ _basis(True)  # [10,10]
        f = _value(ch[0])
        g_t = -mm[1:4, 0]
        m = -mm[1:4, 1:4]
        htt = mm[4 + sym, 0]
        h3 = mm[(4 + sym)[:, :, None], (1 + torch.arange(3, device=dev))[None, None, :]]
        h4 = mm[(4 + sym)[:, None, :, None], (4 + sym)[None, :, None, :]]
        dr, ddr = _rotation_derivatives(p[3:6])
        g_a = torch.einsum("ija,ij->a", dr, m)
        grad = torch.cat([g_t, g_a])
        hta = torch.einsum("jpa,ijp->ia", dr, h3)
        haa = torch.einsum("ipa,jqb,ipjq->ab", dr, dr, h4) + torch.einsum(
            "ijab,ij->ab", ddr, m
        )
        hess = torch.cat([torch.cat([htt, hta], dim=1),
                          torch.cat([hta.T, haa], dim=1)], dim=0)
        return psum((f, grad, hess), group)

    def objective(p):
        return fixed_objective(p, *lookup(p))

    return objective, lookup, fixed_objective, fixed_value_grad, fixed_value_grad_hess


def _more_thuente(vg, p, direction, phi0, g0, step_init, step_max,
                  config: NDTConfig):
    """Line search reproducing the JAX package's frozen-neighbourhood
    More-Thuente: sufficient decrease mu=1e-4 and curvature nu=0.9 (after
    3 trials sufficient decrease alone), safeguarded bisection /
    extrapolation, at most ``line_search_max_iterations`` trials. Each
    trial's stop test is one host sync."""
    mu, nu = 1e-4, 0.9
    step_min = config.transformation_epsilon / 2.0
    dphi0 = torch.dot(g0, direction)
    reverse = dphi0 > 0
    direction = torch.where(reverse, -direction, direction)
    dphi0 = torch.where(reverse, -dphi0, dphi0)

    def trial(a):
        f, g = vg(p + a * direction)
        return f, torch.dot(g, direction)

    a_t = torch.clamp(step_init, step_min, step_max)
    a_l = torch.zeros_like(a_t)
    a_u = torch.zeros_like(a_t)
    done = torch.zeros((), dtype=torch.bool, device=p.device)
    for it in range(config.line_search_max_iterations):
        f_t, g_t = trial(a_t)
        suff = f_t <= phi0 + mu * a_t * dphi0
        curv = g_t.abs() <= nu * dphi0.abs()
        done = suff & (curv | (it >= 3))
        too_high = ~suff
        a_u = torch.where(too_high, a_t, a_u)
        a_l = torch.where(too_high, a_l, a_t)
        next_a = torch.where(a_u > 0, 0.5 * (a_l + a_u),
                             torch.clamp(2.0 * a_t, max=step_max))
        next_a = torch.clamp(next_a, step_min, step_max)
        if bool(done):  # host sync: the trial loop's stop test
            break
        a_t = next_a
    a_result = torch.where(done, a_t, torch.clamp(a_l, min=step_min))
    f_res, _ = trial(a_result)
    a_result = torch.where(f_res < phi0, a_result, 0.0)
    return a_result, direction


def _cubic_min(a_l, f_l, g_l, a_t, f_t, g_t):
    """Minimizer of the cubic through (a_l, f_l, g_l) and (a_t, f_t, g_t)
    (Sun & Yuan 2006, eq. 2.4.52 / 2.4.56, as PCL uses them)."""
    z = 3 * (f_t - f_l) / (a_t - a_l) - g_t - g_l
    w = torch.sqrt(torch.clamp(z * z - g_t * g_l, min=0.0))
    denom = g_t - g_l + 2 * w
    safe = denom.abs() > 1e-30
    ac = a_l + (a_t - a_l) * (w - g_l - z) / torch.where(safe, denom, 1.0)
    return torch.where(safe, ac, a_t)


def _quad_min(a_l, f_l, g_l, a_t, f_t):
    """Minimizer of the quadratic through f_l, g_l and f_t (eq. 2.4.2)."""
    denom = g_l - (f_l - f_t) / (a_l - a_t)
    safe = denom.abs() > 1e-30
    aq = a_l - 0.5 * (a_l - a_t) * g_l / torch.where(safe, denom, 1.0)
    return torch.where(safe, aq, a_t)


def _secant_min(a_l, g_l, a_t, g_t):
    """Minimizer of the quadratic through g_l and g_t (eq. 2.4.5)."""
    denom = g_l - g_t
    safe = denom.abs() > 1e-30
    return torch.where(safe, a_l - (a_l - a_t) / torch.where(safe, denom, 1.0) * g_l, a_t)


def _trial_value(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t):
    """PCL ``trialValueSelectionMT``, cases 1-4, branch-free."""
    a_c = _cubic_min(a_l, f_l, g_l, a_t, f_t, g_t)
    a_q = _quad_min(a_l, f_l, g_l, a_t, f_t)
    a_s = _secant_min(a_l, g_l, a_t, g_t)
    # case 1: f_t > f_l
    c1 = torch.where((a_c - a_l).abs() < (a_q - a_l).abs(), a_c, 0.5 * (a_q + a_c))
    # case 2: f_t <= f_l, g_t * g_l < 0
    c2 = torch.where((a_c - a_t).abs() >= (a_s - a_t).abs(), a_c, a_s)
    # case 3: |g_t| <= |g_l| (same-sign gradients, still decreasing)
    c3_next = torch.where((a_c - a_t).abs() < (a_s - a_t).abs(), a_c, a_s)
    c3 = torch.where(a_t > a_l, torch.minimum(a_t + 0.66 * (a_u - a_t), c3_next),
                     torch.maximum(a_t + 0.66 * (a_u - a_t), c3_next))
    # case 4: the cubic against the upper endpoint
    c4 = _cubic_min(a_u, f_u, g_u, a_t, f_t, g_t)
    return torch.where(f_t > f_l, c1, torch.where(
        g_t * g_l < 0, c2, torch.where(g_t.abs() <= g_l.abs(), c3, c4)))


def _update_interval(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t):
    """PCL ``updateIntervalMT``: cases U1-U3, else converged."""
    u1 = f_t > f_l
    u2 = ~u1 & (g_t * (a_l - a_t) > 0)
    u3 = ~u1 & (g_t * (a_l - a_t) < 0)
    lo = u2 | u3
    new_u = (torch.where(u1, a_t, torch.where(u3, a_l, a_u)),
             torch.where(u1, f_t, torch.where(u3, f_l, f_u)),
             torch.where(u1, g_t, torch.where(u3, g_l, g_u)))
    new_l = (torch.where(lo, a_t, a_l), torch.where(lo, f_t, f_l), torch.where(lo, g_t, g_l))
    return (*new_l, *new_u, ~(u1 | lo))


def _more_thuente_exact(vg, p, direction, phi0, g0, step_init, step_max,
                        config: NDTConfig):
    """The full More-Thuente line search with PCL ``computeStepLengthMT``
    semantics (pcl/registration/impl/ndt.hpp; More & Thuente 1994): the
    trial values from the cubic / quadratic / secant interpolants
    (``_trial_value``, cases 1-4), the interval updates U1-U3, and the
    switch from the auxiliary function psi to phi once psi <= 0 with
    psi' >= 0. ``vg`` refreshes the voxel neighbourhood at every trial,
    as PCL's per-trial ``computeDerivatives`` / ``radiusSearch`` does.
    The last trial is returned as it is (no improved-over-phi0 gate).

    The JAX ``while_loop`` is a host loop whose stop test (the strong
    Wolfe conditions, a converged interval, a zero directional
    derivative) reads one device bool per trial."""
    mu, nu = 1e-4, 0.9
    step_min = config.transformation_epsilon / 2.0
    dphi0 = torch.dot(g0, direction)
    # PCL: a non-descent direction reverses the step
    reverse = dphi0 > 0
    direction = torch.where(reverse, -direction, direction)
    dphi0 = torch.where(reverse, -dphi0, dphi0)
    zero_grad = dphi0 == 0

    def trial(a):
        f, g = vg(p + a * direction)
        return f, torch.dot(g, direction)

    psi_of = lambda a, phi_a: phi_a - phi0 - mu * a * dphi0
    dpsi_of = lambda dphi_a: dphi_a - mu * dphi0

    # the endpoints start from psi at a = 0: psi(0) = 0, psi'(0) = (1 - mu) phi'(0)
    z = torch.zeros_like(dphi0)
    a_l, f_l, g_l = z, z, dpsi_of(dphi0)
    a_u, f_u, g_u = z, z, dpsi_of(dphi0)
    a_t = torch.clamp(step_init, step_min, step_max)
    phi_t, dphi_t = trial(a_t)
    psi_t, dpsi_t = psi_of(a_t, phi_t), dpsi_of(dphi_t)
    open_iv = torch.ones((), dtype=torch.bool, device=p.device)
    iv_conv = torch.zeros_like(open_iv)
    for _ in range(config.line_search_max_iterations):
        wolfe = (psi_t <= 0) & (dphi_t <= -nu * dphi0)
        if bool(iv_conv | wolfe | zero_grad):  # host sync: the trial loop's stop test
            break
        # the next trial from psi while the interval is open, else from phi
        f_sel = torch.where(open_iv, psi_t, phi_t)
        g_sel = torch.where(open_iv, dpsi_t, dphi_t)
        a_t = torch.clamp(_trial_value(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_sel, g_sel),
                          step_min, step_max)
        phi_t, dphi_t = trial(a_t)
        psi_t, dpsi_t = psi_of(a_t, phi_t), dpsi_of(dphi_t)
        # psi -> phi: close the interval and convert the stored endpoint
        # values. PCL's literal conversion is f += phi_0 - mu * d_phi_0 * a
        # (the inverse of psi would add + mu * d_phi_0 * a); its sign is
        # kept, since this mode exists to reproduce PCL, quirks included.
        close = open_iv & (psi_t <= 0) & (dpsi_t >= 0)
        f_l = torch.where(close, f_l + phi0 - mu * dphi0 * a_l, f_l)
        g_l = torch.where(close, g_l + mu * dphi0, g_l)
        f_u = torch.where(close, f_u + phi0 - mu * dphi0 * a_u, f_u)
        g_u = torch.where(close, g_u + mu * dphi0, g_u)
        open_iv = open_iv & ~close
        a_l, f_l, g_l, a_u, f_u, g_u, iv_conv = _update_interval(
            a_l, f_l, g_l, a_u, f_u, g_u, a_t,
            torch.where(open_iv, psi_t, phi_t), torch.where(open_iv, dpsi_t, dphi_t))
    return torch.where(zero_grad, 0.0, a_t), direction


def ndt_align(
    src: Cloud,
    grid: NDTGrid,
    config: NDTConfig = NDTConfig(),
    init_guess: torch.Tensor | None = None,
    group=None,
) -> NDTResult:
    """Align ``src`` onto the NDT grid (PCL ``ndt.align(output, guess)``);
    stops when the step falls below ``transformation_epsilon`` or at the
    iteration cap (both report converged, as PCL does). With ``group``,
    every rank passes the whole ``src`` and solves on its shard of the
    ``max_source_points`` prefix. ``config.pcl_exact_line_search`` runs
    ``_more_thuente_exact`` with the neighbourhood refreshed at every
    trial; ``config.sweep_cells`` selects the compact-cell sweep
    (``_compact_cells``)."""
    dev, dtype = src.xyz.device, src.xyz.dtype
    guess = (torch.eye(4, dtype=dtype, device=dev) if init_guess is None
             else init_guess.to(dtype))
    cap = config.max_source_points
    if 0 < cap < src.capacity:
        # prefix slice: voxel-downsampled sources arrive in hash-shuffled
        # voxel order, so the first ``cap`` rows are a uniform subset
        src = src.map(lambda x: x[:cap])
    if group is not None:
        src = shard_cloud(src, group)
    objective, lookup, _, fvg, fvgh = _make_objective(src, grid, config, group)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    p = _matrix_to_pose(guess)
    it = 0
    while True:
        mu, ic, mask = lookup(p)
        f0, g, h = fvgh(p, mu, ic, mask)
        ridge = 1e-6 * torch.trace(h) / 6.0
        delta, _ = torch.linalg.solve_ex(h + ridge.abs() * eye6, -g)
        delta = torch.where(torch.isfinite(delta).all(), delta, -g)
        norm = torch.linalg.vector_norm(delta)
        direction = delta / torch.clamp(norm, min=1e-30)
        if config.pcl_exact_line_search:
            # one neighbourhood query per trial (PCL's radiusSearch per
            # computeDerivatives call)
            vg = lambda q: fvg(q, *lookup(q))
            search = _more_thuente_exact
        else:
            vg = lambda q: fvg(q, mu, ic, mask)
            search = _more_thuente
        step, direction = search(vg, p, direction, f0, g, norm, config.step_size, config)
        p = p + step * direction
        it += 1
        # host sync: the Newton loop's stop test
        if it >= config.max_iterations or bool(step < config.transformation_epsilon):
            break
    score = -objective(p)
    n = torch.clamp(psum((src.valid.to(dtype).sum(),), group)[0], min=1.0)
    return NDTResult(
        transform=_pose_to_matrix(p),
        converged=torch.ones((), dtype=torch.bool, device=dev),
        iterations=torch.full((), it, dtype=torch.int32, device=dev),
        score=score,
        trans_probability=score / n,
    )
