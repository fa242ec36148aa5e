"""Fixed-capacity cloud buffer ops (port of
``rspc_tpu/registration/bufferops.py``)."""

from __future__ import annotations

import torch

from rspc_tpu_torch.cloud import OPTIONAL_VEC_FIELDS, Cloud, OrganizedCloud, map_optional


def merge_append(dst: Cloud, src: Cloud, gate=None) -> Cloud:
    """Append src's valid points into dst's free tail slots; overflow
    beyond dst's capacity is dropped. ``gate`` (bool tensor): when False
    nothing is appended -- the gate folds into the scatter, so no host
    sync decides it. Returns a new cloud; dst is not modified."""
    cap = dst.capacity
    order = torch.argsort((~src.valid).to(torch.uint8), stable=True)
    svalid = src.valid.index_select(0, order)
    if gate is not None:
        svalid = svalid & gate
    pos = dst.count().to(torch.int64) + torch.arange(
        src.capacity, device=order.device
    )
    write = svalid & (pos < cap)
    # rows that must not land go to one spare row past the end
    pos = torch.where(write, pos, cap)

    def put(buf, rows):
        out = torch.cat([buf, buf[:1]], dim=0)
        out.index_copy_(0, pos, rows.index_select(0, order))
        return out[:cap]

    opt = {
        name: (
            put(getattr(dst, name), getattr(src, name))
            if getattr(dst, name) is not None and getattr(src, name) is not None
            else None
        )
        for name in OPTIONAL_VEC_FIELDS
    }
    valid = torch.cat([dst.valid, dst.valid[:1]])
    valid.index_copy_(0, pos, svalid)
    return Cloud(
        xyz=put(dst.xyz, src.xyz),
        rgb=put(dst.rgb, src.rgb),
        valid=valid[:cap],
        **opt,
    )


def _block_append(dst: Cloud, src: Cloud, offset: int, gate=None) -> Cloud:
    """Append ``src``'s whole fixed-capacity buffer (invalid rows carried
    along masked) at row ``offset``: one contiguous slice write instead
    of merge_append's compacting scatter. The written set of valid points
    is the same; only the slot layout differs (interior holes, which
    every consumer masks). ``gate`` (bool tensor): when False the block
    lands all invalid, so no host sync decides it.

    Unlike the JAX package's ``dynamic_update_slice``, the write is IN
    PLACE: ``dst``'s tensors are updated and ``dst`` itself is returned,
    so a caller that still needs the old buffer must copy it first.
    Caller guarantees ``offset + src.capacity <= dst.capacity``."""
    rows = slice(offset, offset + src.capacity)
    dst.xyz[rows] = src.xyz
    dst.rgb[rows] = src.rgb
    dst.valid[rows] = src.valid if gate is None else src.valid & gate
    for name in OPTIONAL_VEC_FIELDS:
        if getattr(dst, name) is not None and getattr(src, name) is not None:
            getattr(dst, name)[rows] = getattr(src, name)
    return dst


def _as_unorganized(c) -> Cloud:
    """An ``OrganizedCloud`` flattened row-major; a ``Cloud`` as it is."""
    return c.flatten() if isinstance(c, OrganizedCloud) else c


def _stride_cloud(cloud: Cloud, max_points: int) -> Cloud:
    """Deterministic every-k-th-row subsample for score sweeps."""
    cap = cloud.capacity
    if max_points <= 0 or cap <= max_points:
        return cloud
    step = -(-cap // max_points)
    return Cloud(
        xyz=cloud.xyz[::step],
        rgb=cloud.rgb[::step],
        valid=cloud.valid[::step],
        **map_optional(cloud, lambda x: x[::step]),
    )


def _rigid_inverse(t: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid 4x4 (R^T, -R^T p), no linear solve."""
    r = t[..., :3, :3]
    p = t[..., :3, 3]
    out = torch.zeros_like(t)
    out[..., :3, :3] = r.transpose(-1, -2)
    out[..., :3, 3] = -(r.transpose(-1, -2) @ p[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out
