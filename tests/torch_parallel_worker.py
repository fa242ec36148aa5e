"""Rank worker of tests/test_torch_parallel.py and
tests/test_torch_parallel_jax.py: the cases' inputs and configurations,
and what each gloo rank runs.

    python tests/torch_parallel_worker.py RANK INIT_FILE INPUTS.npz OUT_DIR SUITE

A test starts one such process per rank (``start``) and reads their
results back (``collect``). A rank imports this module and the port,
never jax or ``rspc_tpu`` (``run`` checks), so the module holds
everything both sides share in numpy and plain-dict form:
tests/torch_parallel_jax.py runs the JAX package on the same case
functions and configurations, and makes the inputs in INPUTS.npz.

Every rank runs SUITE's collective jobs in one order over three meshes
on gloo: ``make_mesh(4)`` (``data`` x ``points`` = 2 x 2),
``make_mesh(4, axes=("points",))`` and a 4 x 1 mesh whose ``points``
groups hold one rank each (the world-size-1 group); then the single-rank
jobs given to it. SUITE ``port`` holds the jobs that the port's own
single rank and the cheap JAX results check; ``jax`` the sharded ICP
and the chains on the JAX package's edge clouds, which the JAX
package's sharded programs check. Each rank pickles its results to
``out_dir``.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from datetime import timedelta

import numpy as np

WORLD = 4
FRAMES_W, FRAMES_H, N_FRAMES = 80, 60, 3
YAWS = (-0.07, -0.05)  # tests/test_batched_chain.py's first two sequences
NN_CHUNK = 32

# tests/test_batched_chain.py::_cfg and its points-sharded case
CHAIN_CFG = {
    "icp": dict(max_iterations=20, transformation_epsilon=1e-8,
                euclidean_fitness_epsilon=1e-12, max_correspondence_distance=0.25,
                target_chunk=512, use_pallas=False),
    "ndt": dict(dense_grid_dim=16, max_source_points=1024),
    "edge": dict(max_edge_points=1024),
    "voxel": dict(leaf_size=0.05, max_points=1024),
}
ROBUST_CFG = dict(
    CHAIN_CFG, coarse_warm_start=True, coarse_guard_cap=0.1, rescue_inlier_frac=0.2,
    refine=dict(enabled=True, chain=True, anchor_to_first=True, anchor_mode="map",
                leaf_size=0.05, max_points=1024),
)
# tests/test_parallel.py's solver cases
ICP_CFG = {
    "p2p": dict(transformation_epsilon=1e-8, euclidean_fitness_epsilon=1e-12,
                max_iterations=40, max_correspondence_distance=0.1, target_chunk=128),
    "p2l": dict(max_iterations=10, max_correspondence_distance=0.2,
                transformation_epsilon=1e-12, euclidean_fitness_epsilon=1e-12,
                mse_threshold_absolute=1e-16, variant="point_to_plane", huber_delta=0.01,
                target_chunk=128, use_pallas=False),
    "colored": dict(variant="point_to_plane", max_iterations=12,
                    max_correspondence_distance=0.05, transformation_epsilon=1e-12,
                    euclidean_fitness_epsilon=1e-12, mse_threshold_absolute=1e-16,
                    target_chunk=64, use_pallas=False, huber_delta=None, color_weight=1.0),
}
# tests/test_parallel.py's NDT case, and the multi-chip dry run's
# (__graft_entry__.py::dryrun_multichip on 8 devices)
NDT_CFG = {"cube": dict(dense_grid_dim=16, transformation_epsilon=1e-4),
           "wall_floor": dict(dense_grid_dim=12, max_iterations=8)}
# the two optional NDT modes, each on the wall_floor case over the 2 x 2
# mesh's 2-rank points groups
NDT_MODES = {"exact": dict(pcl_exact_line_search=True), "sweep": dict(sweep_cells=256)}


def _box(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    side = rng.integers(0, 2, n)
    pts[np.arange(n), axis] = side - 0.5
    pts[:, 2] += 2.0
    return pts


def _yaw(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _cloud(xyz, **extra):
    n = xyz.shape[0]
    out = {"xyz": xyz.astype(np.float32), "rgb": np.zeros((n, 3), np.float32),
           "valid": np.ones(n, bool)}
    out.update(extra)
    return out


def nn_case(name):
    """(src, src_valid, tgt, tgt_valid): the JAX test's all-valid 64 x 256,
    and a masked 96 x 512."""
    if name == "all_valid":
        rng = np.random.default_rng(0)
        src = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
        tgt = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
        return src, np.ones(64, bool), tgt, np.ones(256, bool)
    rng = np.random.default_rng(1)
    src = rng.uniform(-1, 1, (96, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    return src, rng.random(96) < 0.9, tgt, rng.random(512) < 0.85


def _p2l_pair(seed):
    """Box faces with normals, the source moved by a small yaw and shift
    (tests/test_parallel.py::test_sharded_point_to_plane_matches_single_chip)."""
    rng = np.random.default_rng(seed)
    n = 512
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    side = rng.integers(0, 2, n)
    pts[np.arange(n), axis] = side - 0.5
    nrm = np.zeros((n, 3), np.float32)
    nrm[np.arange(n), axis] = np.where(side == 1, 1.0, -1.0)
    src = pts @ _yaw(0.03).T + np.float32([0.01, -0.02, 0.005])
    return _cloud(src), _cloud(pts, normal=nrm)


def icp_case(name):
    """(src fields, tgt fields) of tests/test_parallel.py's p2p, p2l and
    colored cases."""
    if name == "p2p":
        pts = _box(512, 1)
        moved = pts @ _yaw(0.04).T + np.float32([0.004, -0.002, 0.003])
        return _cloud(pts), _cloud(moved)
    if name == "p2l":
        return _p2l_pair(11)
    rng = np.random.default_rng(7)
    n, m = 128, 256
    q = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    q[:, 2] = 1.0
    i_tgt = 0.5 + 0.3 * np.sin(7.0 * q[:, 0]) * np.cos(7.0 * q[:, 1])
    g = np.stack([0.3 * 7.0 * np.cos(7.0 * q[:, 0]) * np.cos(7.0 * q[:, 1]),
                  -0.3 * 7.0 * np.sin(7.0 * q[:, 0]) * np.sin(7.0 * q[:, 1]),
                  np.zeros(m)], axis=-1).astype(np.float32)
    gray = lambda i: np.stack([i, i, i], -1).astype(np.float32) * 255.0
    tgt = _cloud(q, rgb=gray(i_tgt),
                 normal=np.broadcast_to(np.float32([0, 0, 1]), (m, 3)).copy(), cgrad=g)
    p = rng.uniform(-0.45, 0.45, (n, 3)).astype(np.float32)
    p[:, 2] = 1.0
    w = p + np.float32([0.004, -0.003, 0.0])
    i_src = 0.5 + 0.3 * np.sin(7.0 * w[:, 0]) * np.cos(7.0 * w[:, 1])
    return _cloud(p, rgb=gray(i_src)), tgt


def batch_icp_case(variant):
    """(src, tgt, guesses) of a 2-pair batch: two box pairs (p2p) or two
    faced boxes with normals (p2l), identity guesses."""
    if variant == "p2p":
        pairs = []
        for seed, ang in ((2, 0.03), (3, -0.02)):
            pts = _box(256, seed)
            pairs.append((_cloud(pts), _cloud(pts @ _yaw(ang).T + np.float32([0.003, 0, -0.002]))))
    else:
        pairs = [_p2l_pair(s) for s in (11, 12)]
    stack = lambda k, which: np.stack([p[which][k] for p in pairs])
    keys = lambda which: [k for k in pairs[0][which]]
    src = {k: stack(k, 0) for k in keys(0)}
    tgt = {k: stack(k, 1) for k in keys(1)}
    return src, tgt, np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))


def ndt_case(name):
    """(source xyz, target xyz): points in a 4 m cube moved by a yaw and a
    shift, or a wall and a floor with the source shifted 5 cm."""
    if name == "cube":
        rng = np.random.default_rng(3)
        pts = rng.uniform(0, 4, (1024, 3)).astype(np.float32)
        return pts @ _yaw(0.05).T + np.float32([0.02, 0.0, -0.01]), pts
    rng = np.random.default_rng(5)
    n = 512
    wall = np.stack([rng.uniform(0, 3, n), rng.uniform(0, 2, n),
                     3.0 + rng.normal(0, 0.01, n)], axis=1).astype(np.float32)
    floor = wall.copy()
    floor[:, 1] = rng.normal(0, 0.01, n)
    floor[:, 2] = rng.uniform(0, 3, n)
    tgt = np.concatenate([wall, floor])
    return tgt[::2] + np.float32([0.04, 0.0, -0.03]), tgt


def static_guesses(yaw):
    """The reference's no-IMU guesses, [n-1, 4, 4]: the accumulated yaw
    (tests/test_batched_chain.py::_sequences)."""
    out, acc = [], 0.0
    for _ in range(N_FRAMES - 1):
        acc += yaw
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = _yaw(acc)
        out.append(m)
    return np.stack(out)



# ------------------------------------------------------------ comparisons

# against the JAX package: the port's single-rank tolerance of the same
# function (tests/test_torch_voxel_icp_ndt.py, tests/test_torch_slice.py);
# against the port's own single rank: 10x the JAX package's
# sharded-against-single figure in MULTICHIP_r05.json
JAX_TOL = {"icp": 1e-4, "ndt": 1e-4, "chain": 5e-4, "global": 5e-3}
SINGLE_TOL = {"p2p": 2.64e-6, "p2l": 1.82e-6, "colored": 1.82e-6, "ndt": 1.92e-6,
              "chain": 5.36e-6}


def _flat(x, prefix=""):
    """Nested results -> {path: numpy array}."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(x, list) and not all(isinstance(v, np.ndarray) for v in x):
        out = {}
        for i, v in enumerate(x):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(x)}


def assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# ------------------------------------------------------------------ ranks


def _jobs(inputs, suite):
    """(name, fn) of SUITE's collective jobs, run by every rank in this
    order (a job's collectives must line up across ranks)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from rspc_tpu_torch.config import ICPConfig
    from rspc_tpu_torch.interop import cloud_from_numpy, config_from_dict
    from rspc_tpu_torch.parallel import (
        batched_registration,
        batched_sharded_icp_align,
        make_mesh,
        points_sharded_registration,
        sharded_icp_align,
        sharded_ndt_align,
        sharded_nearest_neighbors,
    )

    meshes = {
        "2x2": make_mesh(WORLD, device_type="cpu"),
        "points4": make_mesh(WORLD, axes=("points",), device_type="cpu"),
        "4x1": init_device_mesh("cpu", (WORLD, 1), mesh_dim_names=("data", "points")),
    }
    t = lambda a: torch.from_numpy(np.array(a))
    chain = _chain_inputs(inputs)
    robust = config_from_dict(ROBUST_CFG)
    plain = config_from_dict(CHAIN_CFG)
    jobs = []
    for case in ICP_CFG:
        cfg = config_from_dict(ICP_CFG[case], ICPConfig)
        src, tgt = (cloud_from_numpy(c) for c in icp_case(case))
        for mesh in ("points4", "2x2"):
            jobs.append((f"icp {case} {mesh}", lambda src=src, tgt=tgt, cfg=cfg, mesh=mesh:
                         _np(sharded_icp_align(src, tgt, meshes[mesh], cfg))))
    for variant in ("p2p", "p2l"):
        src, tgt, guesses = batch_icp_case(variant)
        cfg = config_from_dict(ICP_CFG[variant], ICPConfig)
        jobs.append((f"batched icp {variant} 2x2", lambda src=src, tgt=tgt, g=guesses, cfg=cfg:
                     _np(batched_sharded_icp_align(cloud_from_numpy(src), cloud_from_numpy(tgt),
                                                   t(g), meshes["2x2"], cfg))))
    if suite == "jax":
        with_jax_edges = lambda fn: lambda: _with_jax_edges(inputs, chain, fn)
        jobs.append(("points chain points4 jax edges", with_jax_edges(lambda: _np(
            points_sharded_registration(chain["seq0"], chain["guesses"][0], robust,
                                        meshes["points4"], include_global=False)))))
        jobs.append(("batched 2x2 jax edges", with_jax_edges(lambda: _np(batched_registration(
            chain["stacked"], chain["guesses"], plain, mesh=meshes["2x2"],
            include_global=False)))))
        return jobs
    jobs.append(("mesh shapes", lambda: {
        k: dict(zip(m.mesh_dim_names, m.mesh.shape)) for k, m in meshes.items()
        if k != "4x1"}))
    for case in ("all_valid", "masked"):
        for mesh in ("points4", "2x2"):
            jobs.append((f"nn {case} {mesh}", lambda case=case, mesh=mesh: _np(
                sharded_nearest_neighbors(*map(t, nn_case(case)), meshes[mesh],
                                          chunk=NN_CHUNK))))
    for case in NDT_CFG:
        cfg, grid = _ndt_grid(case, inputs)
        src = cloud_from_numpy(_cloud(ndt_case(case)[0]))
        for mesh in ("points4", "2x2"):
            jobs.append((f"ndt {case} {mesh}", lambda src=src, grid=grid, cfg=cfg, mesh=mesh:
                         _np(sharded_ndt_align(src, grid, meshes[mesh], cfg))))
    for mode in NDT_MODES:
        cfg, grid = _ndt_grid("wall_floor", inputs, mode)
        src = cloud_from_numpy(_cloud(ndt_case("wall_floor")[0]))
        jobs.append((f"ndt {mode} wall_floor 2x2", lambda src=src, grid=grid, cfg=cfg:
                     _np(sharded_ndt_align(src, grid, meshes["2x2"], cfg))))
    for mesh in ("points4", "2x2", "4x1"):
        jobs.append((f"points chain {mesh}", lambda mesh=mesh: _np(points_sharded_registration(
            chain["seq0"], chain["guesses"][0], robust, meshes[mesh], include_global=False))))
    for include_global in (True, False):
        jobs.append((f"batched 2x2 global={include_global}", lambda g=include_global: _np(
            batched_registration(chain["stacked"], chain["guesses"], plain,
                                 mesh=meshes["2x2"], include_global=g))))
    jobs.append(("batched errors", lambda: _errors(
        lambda: batched_registration(chain["stacked"], chain["guesses"], plain,
                                     mesh=meshes["4x1"]),
        lambda: batched_registration(chain["stacked"], chain["guesses"], plain,
                                     mesh=meshes["points4"]),
        lambda: points_sharded_registration(chain["seq0"], chain["guesses"][0], plain,
                                            meshes["2x2"], axis="rows"))))
    return jobs


def _solo_jobs(rank, inputs, one, suite):
    """(name, fn) of SUITE's single-rank references, spread over the
    ranks: the group=None results that the sharded ones are held against,
    and the same solvers on ``one``, a group of this rank alone, which
    must give the same bits."""
    import torch

    from rspc_tpu_torch.config import ICPConfig
    from rspc_tpu_torch.interop import cloud_from_numpy, config_from_dict
    from rspc_tpu_torch.ops.nn import nn_sweep
    from rspc_tpu_torch.ops.umeyama import plane_fit, rigid_fit
    from rspc_tpu_torch.parallel import batched_registration
    from rspc_tpu_torch.registration.chainscan import _registration_fused
    from rspc_tpu_torch.registration.icp import icp_align
    from rspc_tpu_torch.registration.ndt import ndt_align

    t = lambda a: torch.from_numpy(np.array(a))
    chain = _chain_inputs(inputs)
    jobs = []
    plain = config_from_dict(CHAIN_CFG)
    if suite == "jax":
        if rank == 0:
            for use_ndt, name in ((True, "ndt"), (False, "icp")):
                jobs.append((f"batched none jax edges {name}", lambda use_ndt=use_ndt:
                             _with_jax_edges(inputs, chain, lambda: _np(batched_registration(
                                 chain["stacked"], chain["guesses"], plain, use_ndt=use_ndt,
                                 include_global=use_ndt)))))
        return jobs
    if rank == 0:
        for include_global in (True, False):
            jobs.append((f"batched none global={include_global}", lambda g=include_global: _np(
                batched_registration(chain["stacked"], chain["guesses"], plain,
                                     include_global=g))))
    if rank == 1:
        robust = config_from_dict(ROBUST_CFG)
        frames = [chain["seq0"].map(lambda x, i=i: x[i]) for i in range(N_FRAMES)]
        for name, group in (("none", None), ("one", one)):
            jobs.append((f"fused robust {name}", lambda group=group: _np(_slim(
                _registration_fused(frames, chain["guesses"][0], robust, True, group)))))
    if rank == 2:
        for case in ("all_valid", "masked"):
            s, sv, tg, tv = map(t, nn_case(case))
            jobs.append((f"nn {case} single", lambda s=s, sv=sv, tg=tg, tv=tv:
                         _np(nn_sweep(s, sv, tg, tv, 2 * NN_CHUNK))))
        for case in ICP_CFG:
            cfg = config_from_dict(ICP_CFG[case], ICPConfig)
            src, tgt = (cloud_from_numpy(c) for c in icp_case(case))
            for name, group in (("none", None), ("one", one)):
                jobs.append((f"icp {case} {name}", lambda src=src, tgt=tgt, cfg=cfg, g=group:
                             _np(icp_align(src, tgt, cfg, group=g))))
        for variant in ("p2p", "p2l"):
            src, tgt, _ = batch_icp_case(variant)
            cfg = config_from_dict(ICP_CFG[variant], ICPConfig)
            for i in range(2):
                jobs.append((f"batched icp {variant} single {i}",
                             lambda src=src, tgt=tgt, cfg=cfg, i=i: _np(icp_align(
                                 cloud_from_numpy({k: v[i] for k, v in src.items()}),
                                 cloud_from_numpy({k: v[i] for k, v in tgt.items()}), cfg))))
    if rank == 3:
        for case in NDT_CFG:
            cfg, grid = _ndt_grid(case, inputs)
            src = cloud_from_numpy(_cloud(ndt_case(case)[0]))
            for name, group in (("none", None), ("one", one)):
                jobs.append((f"ndt {case} {name}", lambda src=src, grid=grid, cfg=cfg, g=group:
                             _np(ndt_align(src, grid, cfg, group=g))))
        for mode in NDT_MODES:
            cfg, grid = _ndt_grid("wall_floor", inputs, mode)
            src = cloud_from_numpy(_cloud(ndt_case("wall_floor")[0]))
            jobs.append((f"ndt {mode} wall_floor none", lambda src=src, grid=grid, cfg=cfg:
                         _np(ndt_align(src, grid, cfg))))
        rng = np.random.default_rng(5)
        a, b, nrm = (t(rng.normal(size=(200, 3)).astype(np.float32)) for _ in range(3))
        w = t(rng.random(200).astype(np.float32))
        for name, group in (("none", None), ("one", one)):
            jobs.append((f"fits {name}", lambda g=group: _np({
                "rigid": rigid_fit(a, b, w, group=g),
                "plane": plane_fit(a, b, nrm, w, point_mix=0.1, cgrad=nrm, color_resid=w,
                                   group=g)})))
    return jobs


def _with_jax_edges(inputs, chain, fn):
    """fn() with the JAX package's phase-1 edge clouds of each sequence in
    place of the port's (``chainscan.extract_edge_features_batch``; the
    normals stay the port's), as tests/test_torch_robust_paths.py does:
    the two packages' Canny breaks exact NMS ties differently (about ten
    edge pixels of these frames), so this compares the chains alone."""
    import torch

    from rspc_tpu_torch.cloud import Cloud
    from rspc_tpu_torch.registration import chainscan

    real = chainscan.extract_edge_features_batch

    def swapped(frames, edge_cfg):
        _, normals, n_valid = real(frames, edge_cfg)
        # frame 0 is the same view in every sequence: match the last
        b = next(b for b in range(len(YAWS))
                 if torch.equal(frames[-1].xyz, chain["stacked"].xyz[b, -1]))
        fields = [k for k in ("xyz", "rgb", "valid", "normal", "cgrad")
                  if f"edges_{k}" in inputs]
        feats = [Cloud(**{k: torch.from_numpy(inputs[f"edges_{k}"][b, i]) for k in fields})
                 for i in range(len(frames))]
        return feats, normals, n_valid

    chainscan.extract_edge_features_batch = swapped
    try:
        return fn()
    finally:
        chainscan.extract_edge_features_batch = real


def _ndt_grid(case, inputs, mode=None):
    """(the port's NDTConfig, with the NDT_MODES entry ``mode`` if given;
    the JAX package's grid of the case's target)."""
    from rspc_tpu_torch.config import NDTConfig
    from rspc_tpu_torch.interop import config_from_dict, ndt_grid_from_numpy

    cfg = config_from_dict({**NDT_CFG[case], **NDT_MODES.get(mode, {})}, NDTConfig)
    return cfg, ndt_grid_from_numpy(inputs[f"ndt/{case}/moments"],
                                    inputs[f"ndt/{case}/origin"], cfg)


def _slim(out):
    return {"totals": out["totals"],
            "converged": [f.converged for f in out["fine"]],
            "anchor_accepted": out["anchor_accepted"]}


def _chain_inputs(inputs):
    """The JAX-rendered 80x60 sequences as port tensors: ``stacked``
    [B, n, H, W, ...], ``seq0`` [n, H, W, ...] and the guesses [B, n-1, 4, 4]."""
    import torch

    from rspc_tpu_torch.cloud import OrganizedCloud

    t = lambda a: torch.from_numpy(np.array(a))
    stacked = OrganizedCloud(xyz=t(inputs["frames_xyz"]), rgb=t(inputs["frames_rgb"]),
                             valid=t(inputs["frames_valid"]))
    return {"stacked": stacked, "seq0": stacked.map(lambda x: x[0]),
            "guesses": t(np.stack([static_guesses(y) for y in YAWS]))}


def _np(x):
    """Tensors (in dataclasses, dicts, tuples and lists) -> numpy."""
    import dataclasses

    import torch

    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        if x and all(torch.is_tensor(v) for v in x):
            return np.stack([_np(v) for v in x])
        return [_np(v) for v in x]
    return x


def _errors(*calls):
    """The ValueError message of each call (None where it raised none)."""
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def start(tmp, inputs, suite, timeout_s):
    """Write ``inputs`` to ``tmp`` and start the ``WORLD`` ranks of
    SUITE; ``collect`` reads their results."""
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **inputs)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), os.path.join(tmp, "init"), path,
         str(tmp), suite], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    return procs, tmp, timeout_s


def collect(started):
    """Each rank's ``{job: result}``, once every rank has ended with 0."""
    procs, tmp, timeout_s = started
    try:
        logs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    failed = [(r, p.returncode, logs[r]) for r, p in enumerate(procs) if p.returncode]
    assert not failed, failed
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:  # written by our own ranks
            out.append(pickle.load(f))
    return out


def run(rank, init_file, inputs_path, out_dir, suite):
    """One gloo rank: run SUITE's jobs and pickle ``{name: result}`` to
    ``out_dir/rank{rank}.pkl``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=WORLD,
                            rank=rank, timeout=timedelta(seconds=120))
    try:
        with np.load(inputs_path) as z:
            inputs = {k: z[k] for k in z.files}
        # every rank builds every group (new_group is collective); rank r
        # keeps the one that holds only r
        singles = [dist.new_group([r]) for r in range(WORLD)]
        results = {name: fn() for name, fn in _jobs(inputs, suite)}
        results.update({name: fn() for name, fn in _solo_jobs(rank, inputs, singles[rank],
                                                                suite)})
        imported = sorted(m for m in ("jax", "rspc_tpu") if m in sys.modules)
        if imported:
            raise RuntimeError(f"a rank imported {imported}")
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    run(int(sys.argv[1]), *sys.argv[2:6])
