"""Voxel-grid downsampling as a sort + segment mean (port of
``rspc_tpu/ops/voxel.py``): one averaged point (xyz, rgb and, where
carried, normal) per occupied ``leaf_size`` voxel, ``max_points`` output
slots with a validity mask, voxels beyond capacity dropped as a
spatially uniform subset (hash-shuffled voxel order).

Port notes: the uint32 hash runs in int64 with 32-bit masks (and split
multiplies, so no product overflows); the two-key sort ``(hash, key)``
becomes one sort of ``hash << 32 | key``; the dropped scatter rows of the
JAX version (``mode="drop"``) are zeroed. The per-voxel sums are a
segment sum over the sorted rows (``torch.segment_reduce``) instead of a
scatter-add: on the card ``index_add_`` adds with float atomics in an
order that changes from run to run, and a registration built on it does
not repeat its own result (ICP's 1 cm correspondence cap turns last-bit
differences in the voxel means into 1e-4 differences in a transform).
The segment sum adds each voxel's points in a fixed order; on the CPU it
is the scatter-add's order (ascending row), so the sums are unchanged
there.
"""

from __future__ import annotations

import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.utils import profiling

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for 0 <= h < 2^32 in int64, without overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash(key: torch.Tensor) -> torch.Tensor:
    h = key.to(torch.int64)
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    return (h ^ (h >> 16)) & 0x7FFFFFFF


def voxel_downsample(
    cloud: Cloud,
    leaf_size: float,
    max_points: int,
    min_normal_purity: float = 0.0,
) -> Cloud:
    """One averaged point per occupied ``leaf_size`` voxel (voxel
    coordinate floor(x / leaf)); ``min_normal_purity`` drops voxels whose
    mean-normal length |sum n| / count falls below it. Traced as the span
    ``voxel.downsample``."""
    with profiling.span("voxel.downsample", rows=cloud.capacity, slots=max_points):
        return _downsample(cloud, leaf_size, max_points, min_normal_purity)


def _downsample(cloud: Cloud, leaf_size: float, max_points: int,
                min_normal_purity: float) -> Cloud:
    xyz, rgb, valid = cloud.xyz, cloud.rgb, cloud.valid
    n = cloud.capacity
    dev = xyz.device
    inv_leaf = 1.0 / leaf_size

    coords = torch.floor(xyz * inv_leaf).to(torch.int32)
    big_c = 2**20
    cmin = torch.where(valid[:, None], coords, big_c).amin(dim=0)
    cmin = torch.where(cmin == big_c, 0, cmin)
    rel = torch.clamp(coords - cmin, 0, 1023)
    key = (rel[:, 0] << 20) | (rel[:, 1] << 10) | rel[:, 2]
    key = torch.where(valid, key, 2**30)  # invalids sort last

    hkey = torch.where(valid, _hash(key), 2**31 - 1)
    skey, perm = torch.sort((hkey << 32) | key.to(torch.int64), stable=True)

    new_seg = torch.ones((n,), dtype=torch.bool, device=dev)
    new_seg[1:] = skey[1:] != skey[:-1]
    # voxel (segment) id of each sorted row, ascending: the kept voxels
    # 0..max_points-1 are a prefix of the sorted rows
    seg_id = torch.cumsum(new_seg.to(torch.int32), dim=0) - 1
    bounds = torch.searchsorted(
        seg_id, torch.arange(max_points + 1, dtype=seg_id.dtype, device=dev))
    lengths = bounds[1:] - bounds[:-1]

    cols = [torch.ones((n, 1), dtype=xyz.dtype, device=dev), xyz, rgb]
    if cloud.normal is not None:
        cols.append(cloud.normal)
    if cloud.cgrad is not None:
        cols.append(cloud.cgrad)
    upd = torch.where(valid[:, None], torch.cat(cols, dim=-1), 0.0)
    # unsafe: the rows past the kept voxels are left out, so the lengths
    # sum to less than the row count
    acc = torch.segment_reduce(upd.index_select(0, perm), "sum", lengths=lengths,
                               axis=0, unsafe=True)

    counts = acc[:, 0]
    denom = torch.clamp(counts, min=1.0)[:, None]
    out_valid = counts > 0
    out_xyz = torch.where(out_valid[:, None], acc[:, 1:4] / denom, 0.0)
    out_rgb = acc[:, 4:7] / denom
    out_nrm = None
    col = 7
    if cloud.normal is not None:
        sum_n = acc[:, col:col + 3]
        col += 3
        nlen = torch.linalg.vector_norm(sum_n, dim=-1, keepdim=True)
        up = torch.zeros_like(sum_n[0])
        up[2:].fill_(1.0)  # +z; fill_ takes the scalar by value: no copy
        out_nrm = torch.where(
            nlen > 1e-12, sum_n / torch.clamp(nlen, min=1e-12), up
        )
        if min_normal_purity > 0.0:
            purity = nlen[:, 0] / denom[:, 0]
            out_valid = out_valid & (purity >= min_normal_purity)
    out_cg = acc[:, col:col + 3] / denom if cloud.cgrad is not None else None
    return Cloud(xyz=out_xyz, rgb=out_rgb, valid=out_valid, normal=out_nrm,
                 cgrad=out_cg)
