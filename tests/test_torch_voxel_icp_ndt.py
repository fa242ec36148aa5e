"""The port's voxel grid, ICP and NDT against the JAX package, plus the
scipy float64 goldens (``tests/goldens/goldens.json``) and the NDT
derivatives checked with ``torch.func`` in place of ``jax.grad``.

Tolerances: voxel slots exact (integer keys), voxel means atol 1e-5;
ICP / NDT transforms max-abs 1e-4 against JAX (f32 reduction order),
same convergence state, iterations within +-1; goldens at their own
thresholds (< 1e-3 against the scipy oracle for ICP); NDT grid moments
rtol 1e-5; analytic NDT gradient/Hessian against autodiff at the JAX
package's own tolerances (rtol 2e-3 / 5e-3)."""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.cloud import Cloud as JCloud
from rspc_tpu.config import ICPConfig as JICPConfig, NDTConfig as JNDTConfig
from rspc_tpu.io.pcd import load_pcd
from rspc_tpu.ops.voxel import voxel_downsample as j_voxel
from rspc_tpu.registration.icp import icp_align as j_icp
from rspc_tpu.registration.ndt import build_ndt_grid as j_build, ndt_align as j_ndt
from rspc_tpu_torch.config import ICPConfig, NDTConfig
from rspc_tpu_torch.interop import (
    cloud_from_numpy,
    cloud_to_numpy,
    config_from_dict,
    ndt_grid_from_numpy,
)
from rspc_tpu_torch.ops.voxel import _hash, voxel_downsample
from rspc_tpu_torch.registration.icp import icp_align
from rspc_tpu_torch.registration.ndt import (
    _make_objective,
    build_ndt_grid,
    ndt_align,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores, where torch's spinning
    intra-op threads slow every worker down by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
with open(os.path.join(GOLDEN_DIR, "goldens.json")) as _f:
    _CASES = json.load(_f)["cases"]
_ICP = [c for c in _CASES if c["kind"] == "icp"]
_NDT = [c for c in _CASES if c["kind"] == "ndt"]


def _np(c):
    return {k: np.asarray(getattr(c, k)) for k in ("xyz", "rgb", "valid", "normal")
            if getattr(c, k) is not None}


def _port(c):
    return cloud_from_numpy(_np(c))


def _planes(n, seed, noise=0.002):
    """Floor + two walls with unit normals, as f32 arrays."""
    rng = np.random.default_rng(seed)
    k = n // 3
    pts, nrm = [], []
    for axis in range(3):
        p = rng.uniform(-1.5, 1.5, (k, 3))
        p[:, axis] = (1.0 if axis != 1 else -0.8) + rng.normal(0, noise, k)
        m = np.zeros((k, 3))
        m[:, axis] = 1.0
        pts.append(p)
        nrm.append(m)
    return np.concatenate(pts).astype(np.float32), np.concatenate(nrm).astype(np.float32)


def _rigid(rx, ry, rz, t):
    from scipy.spatial.transform import Rotation

    m = np.eye(4)
    m[:3, :3] = Rotation.from_euler("xyz", [rx, ry, rz]).as_matrix()
    m[:3, 3] = t
    return m.astype(np.float32)


# ---------------------------------------------------------------- voxel


def test_hash_matches_uint32_wraparound():
    keys = np.random.default_rng(0).integers(0, 2**30 + 1, 5000).astype(np.uint32)
    h = keys.copy()
    with np.errstate(over="ignore"):
        h = (h ^ (h >> 16)) * np.uint32(0x7FEB352D)
        h = (h ^ (h >> 15)) * np.uint32(0x846CA68B)
        h = (h ^ (h >> 16)) & np.uint32(0x7FFFFFFF)
    got = _hash(torch.from_numpy(keys.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, h.astype(np.int64))


@pytest.mark.parametrize("purity", [0.0, 0.995])
def test_voxel_downsample_matches(purity):
    rng = np.random.default_rng(5)
    n = 6000
    xyz = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm[: n // 2] = (0, 0, 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    valid = rng.random(n) < 0.9
    jc = JCloud(jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(valid), normal=jnp.asarray(nrm))
    for cap in (4096, 700):  # roomy, and saturated (hash-shuffled drop)
        want = j_voxel(jc, 0.04, cap, min_normal_purity=purity)
        got = voxel_downsample(_port(jc), 0.04, cap, min_normal_purity=purity)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        assert got.valid.sum() > 50
        for k in ("xyz", "rgb", "normal"):
            np.testing.assert_allclose(
                getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                rtol=0, atol=1e-5 * (255 if k == "rgb" else 1),
            )


# ---------------------------------------------------------------- ICP


def _icp_pair(variant):
    tgt, tn = _planes(3000, 1)
    t_true = _rigid(0.01, -0.02, 0.015, [0.01, -0.005, 0.008])
    rng = np.random.default_rng(2)
    sel = rng.permutation(len(tgt))[:1500]
    inv = np.linalg.inv(t_true)
    src = (tgt[sel] @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    src += rng.normal(0, 0.001, src.shape).astype(np.float32)
    jt = JCloud(jnp.asarray(tgt), jnp.zeros_like(jnp.asarray(tgt)),
                jnp.ones(len(tgt), bool), normal=jnp.asarray(tn))
    js = JCloud(jnp.asarray(src), jnp.zeros_like(jnp.asarray(src)),
                jnp.ones(len(src), bool))
    kw = dict(max_iterations=20, max_correspondence_distance=0.05,
              transformation_epsilon=1e-10, euclidean_fitness_epsilon=1e-10,
              target_chunk=1024, variant=variant)
    if variant == "point_to_plane":
        kw["huber_delta"] = 0.01
    return js, jt, JICPConfig(**kw), t_true


@pytest.mark.parametrize("variant", ["point_to_point", "point_to_plane"])
def test_icp_align_matches_jax(variant):
    js, jt, jcfg, t_true = _icp_pair(variant)
    want = j_icp(js, jt, jcfg)
    tcfg = config_from_dict(dataclasses.asdict(jcfg), ICPConfig)
    got = icp_align(_port(js), _port(jt), tcfg)
    err = np.abs(got.transform.numpy() - np.asarray(want.transform)).max()
    assert err <= 1e-4, err
    assert int(got.state) == int(want.state)
    assert bool(got.converged) == bool(want.converged)
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    assert np.abs(got.transform.numpy() - t_true).max() < 5e-3
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=1e-3)


def test_icp_guess_and_no_correspondences():
    js, jt, jcfg, _ = _icp_pair("point_to_point")
    far = np.eye(4, dtype=np.float32)
    far[:3, 3] = 10.0  # every match beyond the cap -> NO_CORRESPONDENCES
    want = j_icp(js, jt, jcfg, jnp.asarray(far))
    got = icp_align(_port(js), _port(jt), config_from_dict(
        dataclasses.asdict(jcfg), ICPConfig), torch.from_numpy(far))
    assert int(got.state) == int(want.state) == 5
    assert not bool(got.converged)
    np.testing.assert_array_equal(got.transform.numpy(), far)


@pytest.mark.parametrize("case", _ICP, ids=[c["name"] for c in _ICP])
def test_icp_matches_scipy_golden(case):
    src = _port(load_pcd(os.path.join(GOLDEN_DIR, case["src"])))
    tgt = _port(load_pcd(os.path.join(GOLDEN_DIR, case["tgt"])))
    cfg = ICPConfig(**case["config"], target_chunk=512)
    guess = None if case["guess"] is None else torch.tensor(case["guess"], dtype=torch.float32)
    got = icp_align(src, tgt, cfg, guess)
    want = case["oracle"]
    assert bool(got.converged) == want["converged"]
    assert int(got.state) == want["state"]
    assert abs(int(got.iterations) - want["iterations"]) <= 1
    err = np.abs(got.transform.numpy() - np.asarray(want["transform"])).max()
    assert err < 1e-3, err
    assert abs(float(got.fitness) - want["fitness"]) <= 1e-6 + 0.05 * abs(want["fitness"])


# ---------------------------------------------------------------- NDT


def _ndt_scene():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_ndt import _scene

    tgt = _scene(n=2400, seed=3)
    t_true = _rigid(0.03, -0.05, 0.04, [0.06, -0.04, 0.05])
    rng = np.random.default_rng(4)
    sel = rng.permutation(len(tgt))[:1000]
    inv = np.linalg.inv(t_true)
    src = (tgt[sel] @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    return JCloud.from_numpy(src), JCloud.from_numpy(tgt), t_true


@pytest.fixture(scope="module")
def ndt_pair():
    return _ndt_scene()


@pytest.mark.parametrize("neighborhood", [27, 7])
def test_ndt_grid_matches(ndt_pair, neighborhood):
    _, jt, _ = ndt_pair
    jcfg = JNDTConfig(dense_grid_dim=16, neighborhood=neighborhood)
    want = j_build(jt, jcfg)
    got = build_ndt_grid(_port(jt), config_from_dict(dataclasses.asdict(jcfg), NDTConfig))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    np.testing.assert_allclose(got.moments.numpy(), np.asarray(want.moments),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), atol=1e-5)
    v = np.asarray(want.valid)
    np.testing.assert_allclose(got.inv_covs.numpy()[v], np.asarray(want.inv_covs)[v],
                               rtol=1e-3, atol=1e-2)
    # interop: the JAX grid's raw moments finalize to the same grid
    same = ndt_grid_from_numpy(np.asarray(want.moments), np.asarray(want.origin),
                               config_from_dict(dataclasses.asdict(jcfg), NDTConfig))
    np.testing.assert_array_equal(same.valid.numpy(), v)


@pytest.mark.parametrize("neighborhood", [27, 7])
def test_ndt_align_matches_jax(ndt_pair, neighborhood):
    js, jt, t_true = ndt_pair
    jcfg = JNDTConfig(dense_grid_dim=16, neighborhood=neighborhood)
    want = j_ndt(js, j_build(jt, jcfg), jcfg)
    tcfg = config_from_dict(dataclasses.asdict(jcfg), NDTConfig)
    got = ndt_align(_port(js), build_ndt_grid(_port(jt), tcfg), tcfg)
    err = np.abs(got.transform.numpy() - np.asarray(want.transform)).max()
    assert err <= 1e-4, err
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    np.testing.assert_allclose(float(got.score), float(want.score), rtol=1e-4)
    assert np.abs(got.transform.numpy() - t_true).max() < 2e-2


@pytest.mark.parametrize("neighborhood", [7, 1])
def test_ndt_auto_sweep_cells_matches_jax(ndt_pair, neighborhood):
    """``sweep_cells=-1`` (auto) resolves to the exact gather path for the
    7- and 1-cell neighbourhoods in both packages, so the port runs it and
    agrees with the JAX package as at ``sweep_cells=0``."""
    js, jt, _ = ndt_pair
    jcfg = JNDTConfig(dense_grid_dim=16, neighborhood=neighborhood, sweep_cells=-1)
    want = j_ndt(js, j_build(jt, jcfg), jcfg)
    tcfg = config_from_dict(dataclasses.asdict(jcfg), NDTConfig)
    got = ndt_align(_port(js), build_ndt_grid(_port(jt), tcfg), tcfg)
    err = np.abs(got.transform.numpy() - np.asarray(want.transform)).max()
    assert err <= 1e-4, err
    assert abs(int(got.iterations) - int(want.iterations)) <= 1
    np.testing.assert_allclose(float(got.score), float(want.score), rtol=1e-4)


@pytest.mark.parametrize("case", _NDT, ids=[c["name"] for c in _NDT])
def test_ndt_matches_scipy_golden(case):
    sys.path.insert(0, ROOT)
    from tools.oracles import matrix_to_pose_numpy, ndt_grid_numpy, ndt_score_vectorized

    jsrc = load_pcd(os.path.join(GOLDEN_DIR, case["src"]))
    jtgt = load_pcd(os.path.join(GOLDEN_DIR, case["tgt"]))
    cfg = NDTConfig(dense_grid_dim=16)
    grid = build_ndt_grid(_port(jtgt), cfg)
    want = case["oracle"]
    assert int(grid.valid.sum()) == want["n_valid_cells"]
    got = ndt_align(_port(jsrc), grid, cfg)
    src_np = np.asarray(jsrc.xyz, np.float64)[np.asarray(jsrc.valid)]
    tgt_np = np.asarray(jtgt.xyz, np.float64)[np.asarray(jtgt.valid)]
    stats = ndt_grid_numpy(tgt_np, cfg.resolution, cfg.min_points_per_voxel)
    score = ndt_score_vectorized(stats, cfg.resolution, cfg.outlier_ratio)
    ours = score(matrix_to_pose_numpy(got.transform.numpy().astype(np.float64)), src_np)
    assert ours <= 0.995 * want["neg_score"], (ours, want["neg_score"])
    np.testing.assert_allclose(got.transform.numpy(), np.asarray(want["true_transform"]),
                               atol=2e-2)


def test_ndt_derivatives_match_torch_func(ndt_pair):
    js, jt, _ = ndt_pair
    cfg = NDTConfig(dense_grid_dim=16)
    _, lookup, fobj, fvg, fvgh = _make_objective(
        _port(js), build_ndt_grid(_port(jt), cfg), cfg
    )
    rng = np.random.default_rng(6)
    for p in rng.uniform(-0.15, 0.15, (3, 6)).astype(np.float32):
        p = torch.from_numpy(p)
        mu, ic, mask = lookup(p)
        f, g = fvg(p, mu, ic, mask)
        f2, g2, h = fvgh(p, mu, ic, mask)
        g_ref = torch.func.grad(fobj)(p, mu, ic, mask)
        h_ref = torch.func.hessian(fobj)(p, mu, ic, mask)
        gs = max(float(g_ref.abs().max()), 1e-6)
        hs = max(float(h_ref.abs().max()), 1e-6)
        np.testing.assert_allclose(float(f), float(fobj(p, mu, ic, mask)), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=2e-3, atol=2e-4 * gs)
        np.testing.assert_allclose(g2.numpy(), g_ref.numpy(), rtol=2e-3, atol=2e-4 * gs)
        np.testing.assert_allclose(h.numpy(), h_ref.numpy(), rtol=5e-3, atol=5e-4 * hs)
        np.testing.assert_allclose(h.numpy(), h.numpy().T, atol=1e-5 * hs)


def test_interop_cloud_roundtrip(ndt_pair):
    js, _, _ = ndt_pair
    back = cloud_to_numpy(_port(js))
    for k, v in _np(js).items():
        np.testing.assert_array_equal(back[k], v)
