"""Batched symmetric 3x3 eigendecomposition by cyclic Jacobi sweeps (port
of ``rspc_tpu/ops/eig3.py``): the matrix rides as its 6 independent
components and the basis as 9 component tensors, each Givens rotation a
closed-form elementwise update. Returns (eigenvalues ascending,
eigenvectors as columns), like ``torch.linalg.eigh``."""

from __future__ import annotations

import torch

_PAIRS = ((0, 1), (0, 2), (1, 2))


def _givens(app, aqq, apq):
    """Jacobi rotation (c, s) zeroing the (p, q) entry."""
    small = apq.abs() < 1e-30
    tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, 1.0, t)  # tau == 0 -> 45 deg
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    return torch.where(small, 1.0, c), torch.where(small, 0.0, s)


def eigh3(a: torch.Tensor, sweeps: int = 5):
    """Eigendecomposition of symmetric ``a`` [..., 3, 3]: (w [..., 3]
    ascending, v [..., 3, 3] with v[..., :, i] the eigenvector of w[i])."""
    d = [a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]]
    o = {(0, 1): a[..., 0, 1], (0, 2): a[..., 0, 2], (1, 2): a[..., 1, 2]}
    one = torch.ones_like(d[0])
    zero = torch.zeros_like(d[0])
    v = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]

    def key(i, j):
        return (i, j) if i < j else (j, i)

    for _ in range(sweeps):
        for p, q in _PAIRS:
            r = 3 - p - q
            apq = o[key(p, q)]
            c, s = _givens(d[p], d[q], apq)
            cc, ss, cs = c * c, s * s, c * s
            app, aqq = d[p], d[q]
            d[p] = cc * app - 2.0 * cs * apq + ss * aqq
            d[q] = ss * app + 2.0 * cs * apq + cc * aqq
            o[key(p, q)] = zero
            arp, arq = o[key(r, p)], o[key(r, q)]
            o[key(r, p)] = c * arp - s * arq
            o[key(r, q)] = s * arp + c * arq
            for i in range(3):
                vip, viq = v[i][p], v[i][q]
                v[i][p] = c * vip - s * viq
                v[i][q] = s * vip + c * viq

    w = torch.stack(d, dim=-1)
    vm = torch.stack([torch.stack(row, dim=-1) for row in v], dim=-2)

    # ascending 3-sort (compare-swap network), carrying eigenvector columns
    def swap(w, v, i, j):
        do = w[..., i] > w[..., j]
        cols = [w[..., k] for k in range(3)]
        cols[i], cols[j] = (torch.where(do, w[..., j], w[..., i]),
                            torch.where(do, w[..., i], w[..., j]))
        vcols = [v[..., :, k] for k in range(3)]
        vi, vj = v[..., :, i], v[..., :, j]
        vcols[i] = torch.where(do[..., None], vj, vi)
        vcols[j] = torch.where(do[..., None], vi, vj)
        return torch.stack(cols, dim=-1), torch.stack(vcols, dim=-1)

    w, vm = swap(w, vm, 0, 1)
    w, vm = swap(w, vm, 1, 2)
    w, vm = swap(w, vm, 0, 1)
    return w, vm
