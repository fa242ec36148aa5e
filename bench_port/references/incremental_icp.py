"""Plain reference of the incremental ICP deployment (the upstream
``src/incremental_icp.hpp``): per cloud i >= 1, voxel-downsample it, ICP
it against every earlier cloud as merged so far, with no initial guess,
and on convergence append the whole transformed cloud to the map.

Written from the configuration's numbers alone in plain PyTorch: it
imports nothing of the program. Its parts:

  * the voxel grid: one averaged point per occupied ``leaf`` voxel, every
    occupied voxel kept (PCL's ``VoxelGrid``), the voxel of a point
    ``floor(x * (1 / leaf))`` taken on the f32 coordinates as PCL does;
  * the nearest neighbour of every source among the target rows closer
    than ``max_correspondence_distance`` (lowest index among equal
    distances), by brute force over the targets in the 27 grid cells
    around the source; a source with none there has no correspondence.
    Only correspondences that close count in ICP, so this is PCL's
    k-d tree search as far as ICP sees it;
  * ICP with PCL's ``DefaultConvergenceCriteria`` in PCL's order (too
    few correspondences, iterations, transformation, absolute MSE,
    relative MSE), the previous MSE seeded at 1e18, correspondences
    within ``max_correspondence_distance``, the rigid fit of PCL's
    ``TransformationEstimationSVD`` (Umeyama without scale);
  * the map: frame 0's rows, then each frame's transformed rows in its
    own block, its points kept only where its ICP converged.

``precision`` is ``"float64"`` (the reference: every product and sum in
f64) or ``"tf32"`` (the control: f32 tensors with TF32 matmuls on).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from bench_port.precision import compute_dtype, matmul_precision

REFERENCE = "float64"
CONTROL = "tf32"
NOT_CONVERGED, ITERATIONS, TRANSFORM, ABS_MSE, REL_MSE, NO_CORRESPONDENCES = range(6)
SRC_CHUNK = 8192
# the 27 grid cells around a cell, the cell itself included
_AROUND = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)))


def _voxels(xyz: torch.Tensor, valid: torch.Tensor, leaf: float):
    """The valid points, and the index of each one's voxel among the
    occupied voxels (in the order of the voxel coordinates)."""
    pts = xyz[valid]
    coords = torch.floor(pts * np.float32(1.0 / leaf)).to(torch.int64)
    _, inverse = torch.unique(coords, dim=0, return_inverse=True)
    return pts, inverse


def voxel_means(xyz: torch.Tensor, valid: torch.Tensor, leaf: float,
                dtype) -> torch.Tensor:
    """Every occupied voxel's mean point ``[k, 3]`` in ``dtype``, summed in
    f64."""
    pts, inverse = _voxels(xyz, valid, leaf)
    k = int(inverse.max()) + 1 if inverse.numel() else 0
    sums = torch.zeros((k, 3), dtype=torch.float64, device=xyz.device)
    sums.index_add_(0, inverse, pts.to(torch.float64))
    counts = torch.bincount(inverse, minlength=k).to(torch.float64)
    return (sums / counts[:, None]).to(dtype)


def voxel_count(xyz: torch.Tensor, valid: torch.Tensor, leaf: float) -> int:
    """How many voxels the valid points occupy."""
    _, inverse = _voxels(xyz, valid, leaf)
    return int(inverse.max()) + 1 if inverse.numel() else 0


def nearest(src: torch.Tensor, tgt: torch.Tensor,
            radius: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(squared distance, index) of each row of ``src`` to its nearest row
    of ``tgt`` among those in the 27 grid cells around it, the cells
    0.1% wider than ``radius``, so every target within ``radius`` is among
    them; (inf, 0) where the cells hold none."""
    dev = src.device
    h = radius * 1.001
    cs = torch.floor(src.to(torch.float64) / h).to(torch.int64)
    ct = torch.floor(tgt.to(torch.float64) / h).to(torch.int64)
    lo = torch.minimum(cs.amin(0), ct.amin(0)) - 1
    cs, ct = cs - lo, ct - lo
    dims = torch.maximum(cs.amax(0), ct.amax(0)) + 2

    def key(c):
        return (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]

    order = torch.argsort(key(ct), stable=True)
    keys = key(ct)[order]
    around = _AROUND.to(dev)
    best = torch.full((src.shape[0],), float("inf"), dtype=src.dtype, device=dev)
    arg = torch.zeros((src.shape[0],), dtype=torch.int64, device=dev)
    for base in range(0, src.shape[0], SRC_CHUNK):
        c = cs[base:base + SRC_CHUNK]
        m = c.shape[0]
        want = key((c[:, None, :] + around[None]).reshape(-1, 3))
        first = torch.searchsorted(keys, want)
        count = torch.searchsorted(keys, want, right=True) - first
        total = int(count.sum())
        if total == 0:
            continue
        cell = torch.repeat_interleave(torch.arange(want.numel(), device=dev), count)
        start = torch.cumsum(count, 0) - count
        ti = order[first[cell] + torch.arange(total, device=dev) - start[cell]]
        si = cell // around.shape[0]
        d = src[base + si] - tgt[ti]
        d2 = (d * d).sum(-1)
        bd = torch.full((m,), float("inf"), dtype=src.dtype, device=dev)
        bd.scatter_reduce_(0, si, d2, "amin")
        win = d2 == bd[si]
        ba = torch.full((m,), tgt.shape[0], dtype=torch.int64, device=dev)
        ba.scatter_reduce_(0, si[win], ti[win], "amin")
        best[base:base + m] = bd
        arg[base:base + m] = torch.where(torch.isfinite(bd), ba, 0)
    return best, arg


def rigid_fit(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares rigid ``T`` with ``T src ~= dst`` (Umeyama, no scale)."""
    cs, cd = src.mean(dim=0), dst.mean(dim=0)
    h = (src - cs).T @ (dst - cd)
    u, _, vt = torch.linalg.svd(h.to(torch.float64))
    v = vt.T
    d = torch.ones(3, dtype=torch.float64, device=src.device)
    d[2] = torch.sign(torch.linalg.det(v @ u.T))
    r = (v * d) @ u.T
    t = cd.to(torch.float64) - r @ cs.to(torch.float64)
    out = torch.eye(4, dtype=torch.float64, device=src.device)
    out[:3, :3], out[:3, 3] = r, t
    return out.to(src.dtype)


def icp(src: torch.Tensor, tgt: torch.Tensor, cfg: dict) -> tuple[torch.Tensor, int, int]:
    """PCL ICP of ``src`` onto ``tgt`` from the identity: (transform,
    convergence state, iterations)."""
    dtype = src.dtype
    final = torch.eye(4, dtype=dtype, device=src.device)
    prev_mse = 1e18
    max_d2 = cfg["max_correspondence_distance"] ** 2
    it = 0
    while True:
        moved = src @ final[:3, :3].T + final[:3, 3]
        d2, idx = nearest(moved, tgt, cfg["max_correspondence_distance"])
        inl = d2 <= max_d2
        n = int(inl.sum())
        cur_mse = float(d2[inl].sum()) / max(n, 1)
        it += 1
        if n < cfg["min_number_correspondences"]:
            return final, NO_CORRESPONDENCES, it
        inc = rigid_fit(moved[inl], tgt[idx[inl]])
        cos = 0.5 * (float(inc[0, 0] + inc[1, 1] + inc[2, 2]) - 1.0)
        t2 = float((inc[:3, 3] ** 2).sum())
        eps = cfg["transformation_epsilon"]
        dmse = abs(cur_mse - prev_mse)
        if it >= cfg["max_iterations"]:
            state = ITERATIONS
        elif cos >= 1.0 - eps and t2 <= eps:
            state = TRANSFORM
        elif dmse < cfg["mse_threshold_absolute"]:
            state = ABS_MSE
        elif dmse / max(prev_mse, 1e-30) < cfg["euclidean_fitness_epsilon"]:
            state = REL_MSE
        else:
            state = NOT_CONVERGED
        final = inc @ final
        prev_mse = cur_mse
        if state != NOT_CONVERGED:
            return final, state, it


def register(sweep, cfg: dict, precision: str) -> dict:
    """The map of one sweep (``traffic.Sweep``): per pair the transform,
    whether it converged and its iterations, and the map's rows
    (``xyz f64[n*H*W, 3]``, ``valid bool[n*H*W]``)."""
    dtype = compute_dtype(precision)
    pipe = cfg["pipeline"]
    icp_cfg, leaf = pipe["icp"], pipe["voxel"]["leaf_size"]
    n = sweep.xyz.shape[0]
    xyz = sweep.xyz.reshape(n, -1, 3)
    valid = sweep.valid.reshape(n, -1)
    blocks_xyz = [xyz[0].to(torch.float64)]
    blocks_valid = [valid[0]]
    tgt = xyz[0][valid[0]].to(dtype)
    transforms, converged, iterations = [], [], []
    with matmul_precision(precision):
        for i in range(1, n):
            src = voxel_means(xyz[i], valid[i], leaf, dtype)
            t, state, it = icp(src, tgt, icp_cfg)
            ok = state not in (NOT_CONVERGED, NO_CORRESPONDENCES)
            t64 = t.to(torch.float64)
            moved = xyz[i].to(torch.float64) @ t64[:3, :3].T + t64[:3, 3]
            blocks_xyz.append(moved)
            blocks_valid.append(valid[i] & ok)
            if ok:
                tgt = torch.cat([tgt, moved[valid[i]].to(dtype)])
            transforms.append(t64.cpu().numpy())
            converged.append(ok)
            iterations.append(it)
    return {"transforms": np.stack(transforms), "converged": np.asarray(converged),
            "iterations": np.asarray(iterations),
            "map_xyz": torch.cat(blocks_xyz).cpu().numpy(),
            "map_valid": torch.cat(blocks_valid).cpu().numpy()}


def compare(got: dict, want: dict) -> dict:
    """The numbers that decide ``correct`` for one sweep: the largest
    entry gap of a pair's transform and, where ``got`` holds the map, the
    largest gap of a map point valid on both sides (m) and the map rows
    valid on one side only (a pair's convergence gates its whole block,
    so this count also holds the pairs' convergence to the reference's)."""
    out = {"pair_gap": float(np.abs(got["transforms"] - want["transforms"]).max())}
    if "map_xyz" in got:
        both = got["map_valid"] & want["map_valid"]
        gap = np.abs(got["map_xyz"][both] - want["map_xyz"][both])
        out["map_gap"] = float(gap.max()) if gap.size else 0.0
        out["map_valid_mismatch"] = int((got["map_valid"] != want["map_valid"]).sum())
    return out
