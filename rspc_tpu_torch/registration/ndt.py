"""Normal Distributions Transform registration (port of
``rspc_tpu/registration/ndt.py``, Magnusson 2009 / PCL
``NormalDistributionsTransform`` semantics).

The target lives in a DENSE, INCREMENTAL ``[D^3]`` voxel grid of raw
corner-residual moments (each frame added as one per-cell segment sum);
cells are finalized into means and eigenvalue-inflated inverse
covariances with the batched Jacobi ``eigh3``. The objective uses the
widened-table gather (one row gather per point per Newton iteration,
neighbourhood frozen for the derivatives and the line search),
single-pass analytic gradient and Hessian through a 10x10 gram matmul,
and the closed-form first and second derivatives of
``R = Rx(a) Ry(b) Rz(c)`` in place of ``jacfwd``.

The Newton ``while_loop`` and the safeguarded More-Thuente line search
become Python loops; each stop test reads one device bool (one host sync
per Newton iteration and one per line-search trial). Not ported yet
(ROADMAP.md Queue A): the PCL-exact line search, the compact-cell sweep
(``sweep_cells``) and the sharded form.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.config import NDTConfig
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


def build_ndt_grid(target: Cloud, config: NDTConfig = NDTConfig()) -> NDTGrid:
    """One-shot grid: origin from the cloud's own bounding box."""
    origin = ndt_grid_origin(target, config)
    moments = ndt_grid_update_moments(
        ndt_grid_init(origin, config).moments, origin, target, config
    )
    return ndt_grid_from_moments(moments, origin, config)


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


def _make_objective(src: Cloud, grid: NDTGrid, config: NDTConfig):
    """Returns (objective, lookup, fixed_objective, fixed_value_grad,
    fixed_value_grad_hess) with the JAX package's contracts: f(p) =
    -score(p), minimized by Newton; ``lookup(p)`` freezes the
    neighbourhood at pose p."""
    if config.sweep_cells != 0:
        raise NotImplementedError(
            "the compact-cell NDT sweep is not ported yet (ROADMAP.md Queue A)"
        )
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

    # Per-cell stats packed into one [G,10] row (mean, 6 unique inverse
    # covariance components, validity), widened so that column block j
    # holds the row of the cell at flat offset j: one row gather per
    # point per Newton iteration. The roll's wraparound aliases rows only
    # where a per-axis bound is crossed, and in_b masks exactly those.
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

    def fixed_objective(p, mu, ic6, mask):
        _, _, expt = _common(p, mu, ic6, mask)
        return d1 * expt.sum()

    def fixed_value_grad(p, mu, ic6, mask):
        (be0, be1, be2), _, expt = _common(p, mu, ic6, mask)
        w = d1 * d2 * expt
        ch = torch.stack([expt.sum(-1), (w * be0).sum(-1), (w * be1).sum(-1),
                          (w * be2).sum(-1)])  # [4,N]
        mm = ch @ _basis(False)
        f = d1 * mm[0, 0]
        g_t = -mm[1:4, 0]
        m = -mm[1:4, 1:4]
        dr, _ = _rotation_derivatives(p[3:6])
        g_a = torch.einsum("ija,ij->a", dr, m)
        return f, torch.cat([g_t, g_a])

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
        f = d1 * mm[0, 0]
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
        return f, grad, hess

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


def ndt_align(
    src: Cloud,
    grid: NDTGrid,
    config: NDTConfig = NDTConfig(),
    init_guess: torch.Tensor | None = None,
) -> NDTResult:
    """Align ``src`` onto the NDT grid (PCL ``ndt.align(output, guess)``);
    stops when the step falls below ``transformation_epsilon`` or at the
    iteration cap (both report converged, as PCL does)."""
    if config.pcl_exact_line_search:
        raise NotImplementedError(
            "the PCL-exact line search is not ported yet (ROADMAP.md Queue A)"
        )
    dev, dtype = src.xyz.device, src.xyz.dtype
    guess = (torch.eye(4, dtype=dtype, device=dev) if init_guess is None
             else init_guess.to(dtype))
    cap = config.max_source_points
    if 0 < cap < src.capacity:
        # prefix slice: voxel-downsampled sources arrive in hash-shuffled
        # voxel order, so the first ``cap`` rows are a uniform subset
        src = src.map(lambda x: x[:cap])
    objective, lookup, _, fvg, fvgh = _make_objective(src, grid, config)
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
        vg = lambda q: fvg(q, mu, ic, mask)
        step, direction = _more_thuente(vg, p, direction, f0, g, norm,
                                        config.step_size, config)
        p = p + step * direction
        it += 1
        # host sync: the Newton loop's stop test
        if it >= config.max_iterations or bool(step < config.transformation_epsilon):
            break
    score = -objective(p)
    n = torch.clamp(src.valid.to(dtype).sum(), min=1.0)
    return NDTResult(
        transform=_pose_to_matrix(p),
        converged=torch.ones((), dtype=torch.bool, device=dev),
        iterations=torch.full((), it, dtype=torch.int32, device=dev),
        score=score,
        trans_probability=score / n,
    )
