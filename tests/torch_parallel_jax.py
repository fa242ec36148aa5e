"""The JAX package's side of tests/test_torch_parallel.py and
tests/test_torch_parallel_jax.py, computed live on the cases of
tests/torch_parallel_worker.py.

The JAX package's sharded programs run on the 8 virtual CPU devices that
tests/conftest.py sets up, and single-device. ``inputs`` makes what only
the JAX package makes (the three 80x60 frames of each sequence, rendered
by ``rspc_tpu.capture.synthetic``, their phase-1 edge clouds and the NDT
cases' grids); the rank workers read them from an npz the tests write.
Every result function returns ``{key: numpy array}``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

import torch_parallel_worker as W
from rspc_tpu.capture.synthetic import SyntheticSequence
from rspc_tpu.cloud import Cloud, OrganizedCloud
from rspc_tpu.config import (
    EdgeConfig,
    ICPConfig,
    NDTConfig,
    PipelineConfig,
    RefineConfig,
    VoxelConfig,
)
from rspc_tpu.ops.deproject import Intrinsics
from rspc_tpu.ops.nn import nearest_neighbors
from rspc_tpu.parallel import (
    batched_registration,
    batched_sharded_icp_align,
    make_mesh,
    sharded_icp_align,
    sharded_ndt_align,
    sharded_nearest_neighbors,
)
from rspc_tpu.parallel.chain import points_sharded_registration
from rspc_tpu.registration.chainscan import _phase1_prepare
from rspc_tpu.registration.icp import icp_align
from rspc_tpu.registration.ndt import build_ndt_grid, ndt_align
from rspc_tpu.registration.schemes import _registration_fused


def pipeline_config(d: dict) -> PipelineConfig:
    """A plain-dict configuration of torch_parallel_worker.py as the JAX
    package's ``PipelineConfig``."""
    kw = {k: v for k, v in d.items() if not isinstance(v, dict)}
    return PipelineConfig(
        icp=ICPConfig(**d["icp"]), ndt=NDTConfig(**d["ndt"]), edge=EdgeConfig(**d["edge"]),
        voxel=VoxelConfig(**d["voxel"]), refine=RefineConfig(**d.get("refine", {})), **kw)


def _cloud(fields: dict) -> Cloud:
    return Cloud(**{k: jnp.asarray(v) for k, v in fields.items()})


def _np(out: dict) -> dict:
    return {k: np.asarray(v) for k, v in out.items()}


def _icp_fields(prefix: str, res, out: dict) -> None:
    for k in ("transform", "converged", "iterations", "fitness"):
        out[f"{prefix}/{k}"] = getattr(res, k)


def inputs(edges: bool) -> dict:
    """The frames [B, n, H, W, ...], each NDT case's target grid and,
    with ``edges``, the frames' phase-1 edge clouds [B, n, cap, ...]."""
    out = {}
    seqs = [SyntheticSequence(n_frames=W.N_FRAMES, yaw_step=y,
                              intr=Intrinsics.simple(W.FRAMES_W, W.FRAMES_H)) for y in W.YAWS]
    clouds = [s.clouds() for s in seqs]
    for k in ("xyz", "rgb", "valid"):
        out[f"frames_{k}"] = np.stack([np.stack([np.asarray(getattr(c, k)) for c in cs])
                                       for cs in clouds])
    for case, kw in W.NDT_CFG.items():
        grid = build_ndt_grid(Cloud.from_numpy(W.ndt_case(case)[1]), NDTConfig(**kw))
        out[f"ndt/{case}/moments"], out[f"ndt/{case}/origin"] = grid.moments, grid.origin
    if not edges:
        return _np(out)
    stacked = OrganizedCloud(*(jnp.asarray(out[f"frames_{k}"]) for k in ("xyz", "rgb", "valid")))
    # the edge clouds of phase 1, which the ranks swap into the port's
    # (the jitted Canny breaks exact NMS ties differently)
    edge_cfg = pipeline_config(W.CHAIN_CFG).edge
    feats = [_phase1_prepare(jax.tree.map(lambda x, b=b: x[b], stacked), edge_cfg, 0.05, 1024,
                             False)[0] for b in range(len(W.YAWS))]
    for k in ("xyz", "rgb", "valid", "normal", "cgrad"):
        if getattr(feats[0], k) is not None:
            out[f"edges_{k}"] = np.stack([np.asarray(getattr(f, k)) for f in feats])
    return _np(out)


def nn_results() -> dict:
    """The sharded sweep (8 devices) and the single one, on both cases."""
    out = {}
    for case in ("all_valid", "masked"):
        s, sv, t, tv = (jnp.asarray(a) for a in W.nn_case(case))
        d2, idx = sharded_nearest_neighbors(s, sv, t, tv, make_mesh(8, axes=("points",)),
                                            chunk=W.NN_CHUNK)
        out[f"nn/{case}/sharded/d2"], out[f"nn/{case}/sharded/idx"] = d2, idx
        d2, idx = nearest_neighbors(s, sv, t, tv, chunk=2 * W.NN_CHUNK)
        out[f"nn/{case}/single/d2"], out[f"nn/{case}/single/idx"] = d2, idx
    return _np(out)


def icp_single_results() -> dict:
    """Each ICP case on one device."""
    out = {}
    for case, kw in W.ICP_CFG.items():
        src, tgt = (_cloud(c) for c in W.icp_case(case))
        _icp_fields(f"icp/{case}/single", icp_align(src, tgt, ICPConfig(**kw)), out)
    return _np(out)


def icp_sharded_results() -> dict:
    """Each ICP case sharded over 8 devices; the two batched cases on a
    2 x 4 mesh."""
    out = {}
    mesh8 = make_mesh(8, axes=("points",))
    for case, kw in W.ICP_CFG.items():
        src, tgt = (_cloud(c) for c in W.icp_case(case))
        _icp_fields(f"icp/{case}/sharded", sharded_icp_align(src, tgt, mesh8, ICPConfig(**kw)),
                    out)
    for variant in ("p2p", "p2l"):
        src, tgt, guesses = W.batch_icp_case(variant)
        res = batched_sharded_icp_align(_cloud(src), _cloud(tgt), jnp.asarray(guesses),
                                        make_mesh(8), ICPConfig(**W.ICP_CFG[variant]))
        _icp_fields(f"batched_icp/{variant}", res, out)
    return _np(out)


def ndt_results() -> dict:
    """Each NDT case sharded (the JAX test's 4 devices for the cube, the
    dry run's 8 for the wall) and single."""
    out = {}
    for case, kw in W.NDT_CFG.items():
        cfg = NDTConfig(**kw)
        grid = build_ndt_grid(Cloud.from_numpy(W.ndt_case(case)[1]), cfg)
        src = Cloud.from_numpy(W.ndt_case(case)[0])
        mesh = make_mesh(4 if case == "cube" else 8, axes=("points",))
        for name, res in (("sharded", sharded_ndt_align(src, grid, mesh, cfg)),
                          ("single", ndt_align(src, grid, cfg))):
            for k in ("transform", "score", "iterations"):
                out[f"ndt/{case}/{name}/{k}"] = getattr(res, k)
    return _np(out)


def chain_results(frames: dict) -> dict:
    """The points-sharded robust chain (8 devices) and its single-device
    program on sequence 0; the unsharded batch with NDT (with the global
    clouds) and ICP coarse stages; the data-sharded batch on a 2 x 4
    mesh."""
    out = {}
    stacked = OrganizedCloud(*(jnp.asarray(frames[f"frames_{k}"])
                               for k in ("xyz", "rgb", "valid")))
    guesses = jnp.asarray(np.stack([W.static_guesses(y) for y in W.YAWS]))
    seq0 = jax.tree.map(lambda x: x[0], stacked)
    r = pipeline_config(W.ROBUST_CFG)
    got = points_sharded_registration(seq0, guesses[0], r, make_mesh(8, axes=("points",)),
                                      include_global=False)
    for k in ("totals", "converged", "anchor_accepted"):
        out[f"points_chain/sharded/{k}"] = got[k]
    single = _registration_fused(
        seq0, guesses[0], r.edge, True, r.ndt, r.icp, r.refine, r.voxel.leaf_size,
        r.voxel.max_points, r.coarse_guard_cap, r.coarse_warm_start, r.rescue_inlier_frac,
        r.rescue_cap, r.rescue_iterations)
    out["points_chain/single/totals"] = single["totals"]
    out["points_chain/single/converged"] = single["fine"].converged
    plain = pipeline_config(W.CHAIN_CFG)
    got = batched_registration(stacked, guesses, plain, use_ndt=True)
    for k in ("totals", "converged", "fitness", "anchor_accepted"):
        out[f"batched/ndt/{k}"] = got[k]
    out["batched/ndt/global_xyz"] = got["global"].xyz
    out["batched/ndt/global_valid"] = got["global"].valid
    got = batched_registration(stacked, guesses, plain, use_ndt=False, include_global=False)
    out["batched/icp/totals"], out["batched/icp/converged"] = got["totals"], got["converged"]
    got = batched_registration(stacked, guesses, plain, use_ndt=True, mesh=make_mesh(8),
                               include_global=False)
    out["batched/data_mesh/totals"] = got["totals"]
    out["batched/data_mesh/converged"] = got["converged"]
    return _np(out)
