"""Per-point tangent-plane intensity gradients for colored ICP (port of
``rspc_tpu/ops/colorgrad.py``).

The colored residual ``g . (T p - q) + (I_src - I_tgt)`` (Park, Zhou,
Koltun, "Colored Point Cloud Registration Revisited", ICCV 2017) has the
row structure of the point-to-plane term with the unit normal replaced
by the target's tangent-plane intensity gradient ``g``, so it drops into
the 6x6 moment solve (``ops/umeyama.py::plane_fit_moments`` with a
residual offset). The field is computed once per frame in image space:
central differences over the pixel grid and, per pixel, the 3x3 weighted
least squares

    [ dp_u^T ]       [ dI_u ]
    [ dp_v^T ]  g =  [ dI_v ]      rows normalized to unit |dp|,
    [  n^T   ]       [  0   ]      closed-form adjugate inverse,

then ``g`` projected exactly onto the tangent plane. Gradients ride
through the voxel downsample as per-voxel means on ``Cloud.cgrad``.
Images are ``[..., H, W]`` (``[..., H, W, 3]`` for xyz and normals), so
stacked frames run together.
"""

from __future__ import annotations

import torch

from rspc_tpu_torch.cloud import OrganizedCloud


def intensity(rgb: torch.Tensor) -> torch.Tensor:
    """Luma in [0, 1] from 0..255 RGB (Rec. 601 weights)."""
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]) / 255.0


def _solve3(m: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """Batched 3x3 solve through the adjugate, elementwise. Rows with
    |det| <= eps return 0."""
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a10, a11, a12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    a20, a21, a22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    # c[i][j] above is the ADJUGATE entry adj[i][j] (= cofactor C[j][i]),
    # so the solve below is inv(m) b = adj(m) b / det for any m; the det
    # expansion along row 0 needs the COFACTORS of row 0, i.e. adj
    # column 0 (c00, c10, c20) — using (c00, c01, c02) is only correct
    # for symmetric m.
    det = a00 * c00 + a01 * c10 + a02 * c20
    ok = det.abs() > eps
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    g0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
    g1 = (c10 * b0 + c11 * b1 + c12 * b2) * inv_det
    g2 = (c20 * b0 + c21 * b1 + c22 * b2) * inv_det
    return torch.stack([g0, g1, g2], dim=-1)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=-1))


def color_gradients(
    oc: OrganizedCloud,
    normals: torch.Tensor,
    normals_valid: torch.Tensor,
    step_ratio: float = 4.0,
    max_step: float = 0.1,
) -> torch.Tensor:
    """Tangent-plane intensity gradient ``g f32[..., H, W, 3]`` (intensity
    units per meter) at every organized pixel, from the integral-image
    ``normals``/``normals_valid`` phase 1 already computes. Pixels whose
    u/v neighbours are invalid lose the corresponding difference row;
    with both rows gone (or a degenerate system) the gradient is zero,
    which mutes the colored residual there."""
    i_img = intensity(oc.rgb)
    xyz, valid = oc.xyz, oc.valid

    def edge_ok(axis):
        """``axis`` 0 is the image rows (v), 1 the columns (u)."""
        d = valid.dim() - 2 + axis
        ok = torch.roll(valid, -1, d) & torch.roll(valid, 1, d) & valid
        # roll wraps; kill the image-border rows/cols explicitly
        n = ok.shape[d]
        idx = torch.arange(n, device=ok.device)
        border = (idx > 0) & (idx < n - 1)
        shape = [1, 1]
        shape[axis] = n
        return ok & border.reshape(shape)

    def axis_rows(axis):
        d3 = xyz.dim() - 3 + axis
        d2 = i_img.dim() - 2 + axis
        pf = torch.roll(xyz, -1, d3) - xyz
        pb = xyz - torch.roll(xyz, 1, d3)
        dp = pf + pb  # central difference
        di = torch.roll(i_img, -1, d2) - torch.roll(i_img, 1, d2)
        # Depth-discontinuity gate: a row straddling an occlusion edge
        # has one step much larger than the other — its "gradient" is
        # occlusion geometry, not texture; max_step is the absolute
        # backstop.
        nf, nb = _norm3(pf), _norm3(pb)
        symmetric = torch.maximum(nf, nb) <= step_ratio * torch.minimum(nf, nb) + 1e-6
        small = torch.maximum(nf, nb) <= max_step
        return dp, di, edge_ok(axis) & symmetric & small

    dp_v, di_v, ok_v = axis_rows(0)
    dp_u, di_u, ok_u = axis_rows(1)

    def norm_row(dp, di, ok):
        n2 = (dp * dp).sum(dim=-1)
        inv = torch.where(n2 > 1e-12, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-12)), 0.0)
        w = (ok & (n2 > 1e-12)).to(dp.dtype)
        return dp * inv[..., None] * w[..., None], di * inv * w

    au, bu = norm_row(dp_u, di_u, ok_u)
    av, bv = norm_row(dp_v, di_v, ok_v)
    both = valid & normals_valid
    n_row = torch.where(both[..., None], normals, 0.0).to(xyz.dtype)

    def outer(a):
        return a[..., :, None] * a[..., None, :]

    m = outer(au) + outer(av) + outer(n_row)
    rhs = au * bu[..., None] + av * bv[..., None]
    g = _solve3(m, rhs, eps=1e-6)
    # exact tangency (the LS row only enforces it softly)
    g = g - n_row * (g * n_row).sum(dim=-1, keepdim=True)
    g = torch.where(both[..., None], g, 0.0)
    return torch.where(torch.isfinite(g), g, 0.0)
