"""SE(3) pose-graph relaxation (port of ``rspc_tpu/registration/posegraph.py``;
beyond the reference, which composes pairwise alignments and stops).

Every pairwise measurement (consecutive chain results and redundant
skip-pair alignments) is a soft constraint; the solve finds the
maximum-likelihood trajectory, averaging per-pair noise instead of
integrating it. Residuals are right-tangent SE(3) log-errors r_k =
log(M_k^{-1} T_i^{-1} T_j); the Jacobian is ``torch.func.jacfwd`` over
the stacked 6(n-1) pose corrections, as the JAX package takes
``jax.jacfwd``; pose 0 is pinned at the identity. All in f32, as there.

``_rot_exp`` and ``_log_so3`` are written so that the branch a
``torch.where`` drops stays finite under forward-mode differentiation
(Gauss-Newton linearizes at the identity, where the plain forms divide
by zero); they follow the JAX package term for term, clips included
(``torch.minimum``/``torch.maximum`` split ties as ``jnp.clip`` does).
Every ``torch.where`` takes tensors of the primal's dtype: a Python
scalar there gives its tangent the default dtype, which would turn the
Jacobian into float64.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd


def _clip(x, lo: float, hi: float):
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def _skew(w: torch.Tensor) -> torch.Tensor:
    kx, ky, kz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(kx)
    return torch.stack([
        torch.stack([zero, -kz, ky], dim=-1),
        torch.stack([kz, zero, -kx], dim=-1),
        torch.stack([-ky, kx, zero], dim=-1),
    ], dim=-2)


def _rot_exp(omega: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` axis-angle -> ``[..., 3, 3]`` rotation, differentiable
    at zero: written in a^2 with Taylor branches."""
    a2 = (omega * omega).sum(dim=-1)
    small = a2 < 1e-8
    a2s = torch.where(small, torch.ones_like(a2), a2)
    a = torch.sqrt(a2s)
    s = torch.where(small, 1.0 - a2 / 6.0, torch.sin(a) / a)
    c = torch.where(small, 0.5 - a2 / 24.0, (1.0 - torch.cos(a)) / a2s)
    k = _skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + s[..., None, None] * k + c[..., None, None] * (k @ k)


def _log_so3(r: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3]`` rotation -> ``[..., 3]`` axis-angle, differentiable
    at the identity (the near branch is the Taylor form of
    ang / (2 sin ang) in (1 - cos))."""
    cos = _clip(0.5 * (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1.0), -1.0, 1.0)
    near = cos > 1.0 - 1e-6
    cs = torch.where(near, torch.zeros_like(cos), cos)  # safe value for the exact branch
    exact = torch.arccos(cs) / (2.0 * torch.sqrt(torch.clamp(1.0 - cs * cs, min=1e-12)))
    taylor = 0.5 + (1.0 - cos) / 6.0
    s = torch.where(near, taylor, exact)
    skew = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                        r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    return s[..., None] * skew


def _rigid(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([r, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :]) + torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=r.dtype, device=r.device)
    return torch.cat([top, bottom], dim=-2)


def se3_exp(x: torch.Tensor) -> torch.Tensor:
    """``[..., 6]`` tangent (omega, v) -> ``[..., 4, 4]`` rigid transform,
    the translation applied directly (first-order-exact coupling,
    consistent with :func:`se3_log`)."""
    return _rigid(_rot_exp(x[..., :3]), x[..., 3:])


def se3_log(t: torch.Tensor) -> torch.Tensor:
    """``[..., 4, 4]`` rigid transform -> ``[..., 6]`` tangent; the
    inverse of :func:`se3_exp`."""
    return torch.cat([_log_so3(t[..., :3, :3]), t[..., :3, 3]], dim=-1)


def _inv(t: torch.Tensor) -> torch.Tensor:
    rt = t[..., :3, :3].transpose(-1, -2)
    return _rigid(rt, -(rt @ t[..., :3, 3:])[..., 0])


def optimize_pose_graph(
    totals: torch.Tensor,    # f32[n-1, 4, 4] absolute poses frame i+1 -> frame 0
    edges_i: torch.Tensor,   # i64[m] constraint source frame index (0..n-1)
    edges_j: torch.Tensor,   # i64[m] constraint target frame index (j > i)
    measures: torch.Tensor,  # f32[m, 4, 4] measured frame-j -> frame-i transform
    weights: torch.Tensor,   # f32[m] per-constraint weight (0 disables)
    iters: int = 10,
    damping: float = 1e-6,
    huber_delta: float = 0.01,
):
    """Refined ``totals`` minimizing the robustly weighted residual sum of
    ||w_k log(M_k^{-1} T_i^{-1} T_j)|| with T_0 = I fixed, and the cost of
    each of the ``iters`` Gauss-Newton steps. Poses take right-multiplied
    corrections T_i <- T_i exp(dx_i); each step solves the damped dense
    normal equations over the 6(n-1) parameters, with Huber IRLS factors
    min(1, delta/||r_k||) per constraint block frozen at the step's
    start; a non-finite step is dropped."""
    n_free = totals.shape[0]
    dtype, dev = totals.dtype, totals.device
    eye = torch.eye(4, dtype=dtype, device=dev)
    ei, ej = edges_i.long(), edges_j.long()
    # absolute pose of frame k (0 = the anchored identity)
    base = torch.cat([eye[None], totals], dim=0)
    inv_m = _inv(measures)
    sqw = torch.sqrt(torch.clamp(weights, min=0.0))

    def raw_residuals(x):
        dx = torch.cat([torch.zeros(1, 6, dtype=dtype, device=dev), x.reshape(n_free, 6)])
        poses = base @ se3_exp(dx)
        return se3_log(inv_m @ _inv(poses.index_select(0, ei)) @ poses.index_select(0, ej))

    x = torch.zeros(n_free * 6, dtype=dtype, device=dev)
    costs = []
    for _ in range(iters):
        rn = torch.linalg.vector_norm(raw_residuals(x), dim=1)
        hub = torch.clamp(huber_delta / torch.clamp(rn, min=1e-12), max=1.0)
        row_w = sqw * torch.sqrt(hub)

        def residuals(xx):
            return (raw_residuals(xx) * row_w[:, None]).reshape(-1)

        r = residuals(x)
        jac = jacfwd(residuals)(x)  # [6m, 6(n-1)]
        h = jac.T @ jac
        g = jac.T @ r
        h = h + (damping * torch.trace(h) / h.shape[0] + 1e-12) * torch.eye(
            h.shape[0], dtype=dtype, device=dev)
        dx = torch.linalg.solve_ex(h, -g)[0]  # no error check: no host sync
        x = x + torch.where(torch.isfinite(dx).all(), dx, 0.0)
        costs.append((r * r).sum())
    refined = totals @ se3_exp(x.reshape(n_free, 6))
    return refined, torch.stack(costs)
