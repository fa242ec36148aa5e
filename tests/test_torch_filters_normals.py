"""The port's input-side modules against the JAX package (CPU): the
pass-through and statistical-outlier filters, radius-search normals,
Brown-Conrady undistortion, and ``compose``, ``concatenate`` and the
native ``KDTree``.

Shapes are those of the JAX package's own tests
(tests/test_image_ops.py: the 201-point cluster with its outlier, the
400-point tilted plane, the 64x48 distortion grid), plus a seeded
600-point cloud with invalid slots for each filter and a curved
surface for the normals.

Tolerances: filter masks equal; normals atol 1e-4 with the valid masks
equal (f32 moment sums in another order); undistorted coordinates atol
1e-6 against the JAX package and 2e-4 against the numpy forward model
(the JAX test's bound); deprojected points atol 1e-6; ``compose`` atol
1e-6 (four-term f32 dot products, rounded in another order);
``concatenate`` exact; the kd-tree's squared distances and indices exact
(two builds of the same native sources; tests/torch_native.py loads the
JAX package's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.cloud import Cloud as JCloud
from rspc_tpu.cloud import concatenate as j_concatenate
from rspc_tpu.ops import deproject as jd
from rspc_tpu.ops.filters import passthrough as j_pass
from rspc_tpu.ops.filters import statistical_outlier_removal as j_sor
from rspc_tpu.ops.normals import estimate_normals_radius as j_normals
from rspc_tpu.ops.transform import compose as j_compose
from rspc_tpu_torch.cloud import concatenate
from rspc_tpu_torch.interop import cloud_from_numpy, cloud_to_numpy, intrinsics_from_dict
from rspc_tpu_torch.io import native
from rspc_tpu_torch.ops import deproject as td
from rspc_tpu_torch.ops.filters import passthrough, statistical_outlier_removal
from rspc_tpu_torch.ops.normals import estimate_normals_radius
from rspc_tpu_torch.ops.transform import compose
from torch_native import jax_native


t = lambda a: torch.from_numpy(np.array(a))


def _np(c):
    return {k: np.asarray(getattr(c, k)) for k in ("xyz", "rgb", "valid", "normal")
            if getattr(c, k) is not None}


def _cloud(n=600, seed=0):
    """Points in a 2 m box 1 m ahead, a tenth of the slots invalid, and a
    few far strays."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32) + np.float32([0, 0, 2])
    xyz[rng.choice(n, 12, replace=False)] *= 4.0
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    return JCloud.from_numpy(xyz, rgb, valid=rng.random(n) > 0.1)


@pytest.mark.parametrize("field", ["x", "y", "z"])
def test_passthrough_matches_jax(field):
    jc = _cloud()
    want = j_pass(jc, field, -0.5, 2.5)
    got = passthrough(cloud_from_numpy(_np(jc)), field, -0.5, 2.5)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    assert 0 < int(got.valid.sum()) < int(np.asarray(jc.valid).sum())


def _cluster():
    rng = np.random.default_rng(7)
    cluster = rng.normal(0, 0.01, (200, 3)).astype(np.float32) + [0, 0, 1]
    return JCloud.from_numpy(np.concatenate([cluster, np.float32([[5, 5, 5]])]))


@pytest.mark.parametrize("case", ["cluster", "box"])
def test_statistical_outlier_removal_matches_jax(case):
    if case == "cluster":  # tests/test_image_ops.py's case
        jc, kw = _cluster(), dict(mean_k=10, stddev_mult=1.5, chunk=64)
    else:
        jc, kw = _cloud(seed=1), dict(mean_k=20, stddev_mult=1.0, chunk=128)
    want = np.asarray(j_sor(jc, **kw).valid)
    got = statistical_outlier_removal(cloud_from_numpy(_np(jc)), **kw).valid.numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (np.asarray(jc.valid) & ~got).sum()
    if case == "cluster":
        assert not got[200] and got[:200].sum() > 150


def _plane():
    rng = np.random.default_rng(3)
    uv = rng.uniform(-0.5, 0.5, (400, 2)).astype(np.float32)
    n_true = np.array([1.0, 2.0, -2.0], np.float32)
    n_true /= np.linalg.norm(n_true)
    e1 = np.cross(n_true, [0.0, 0.0, 1.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n_true, e1)
    return (uv[:, :1] * e1 + uv[:, 1:] * e2 + [0.0, 0.0, 2.0]).astype(np.float32)


def _bowl():
    rng = np.random.default_rng(4)
    xy = rng.uniform(-0.6, 0.6, (500, 2)).astype(np.float32)
    z = 1.5 + 0.4 * (xy ** 2).sum(axis=1)
    pts = np.c_[xy, z].astype(np.float32)
    pts[:3] = [[4, 4, 4], [-4, 4, 4], [4, -4, 4]]  # too few neighbours
    return pts


@pytest.mark.parametrize("case", ["plane", "bowl"])
def test_estimate_normals_radius_matches_jax(case):
    pts = _plane() if case == "plane" else _bowl()
    valid = np.ones(len(pts), bool)
    if case == "bowl":
        valid[5::17] = False
    jc = JCloud.from_numpy(pts, valid=valid)
    want_n, want_ok = (np.asarray(a) for a in j_normals(jc, radius=0.15, chunk=128))
    got_n, got_ok = estimate_normals_radius(cloud_from_numpy(_np(jc)), radius=0.15, chunk=128)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    np.testing.assert_allclose(got_n.numpy(), want_n, rtol=0, atol=1e-4)
    assert want_ok.sum() > 0.8 * len(pts)
    if case == "bowl":
        assert not got_ok.numpy()[:3].any() and (got_n.numpy()[:3] == 0).all()


_INTR = dict(width=64, height=48, fx=40.0, fy=40.0, ppx=32.0, ppy=24.0,
             coeffs=(0.1, -0.05, 0.001, 0.001, 0.01))


def test_undistort_brown_conrady_matches_jax():
    """tests/test_image_ops.py's round trip: a grid distorted by the
    forward model in float64 comes back through the port's iteration."""
    k1, k2, p1, p2, k3 = _INTR["coeffs"]
    xu = (np.arange(64) - 32.0) / 40.0
    yu = (np.arange(48) - 24.0) / 40.0
    xg, yg = np.meshgrid(xu, yu)
    r2 = xg ** 2 + yg ** 2
    f = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = (xg * f + 2 * p1 * xg * yg + p2 * (r2 + 2 * xg ** 2)).astype(np.float32)
    yd = (yg * f + 2 * p2 * xg * yg + p1 * (r2 + 2 * yg ** 2)).astype(np.float32)
    wx, wy = jd._undistort_brown_conrady(jnp.asarray(xd), jnp.asarray(yd), _INTR["coeffs"])
    gx, gy = td._undistort_brown_conrady(t(xd), t(yd), _INTR["coeffs"])
    np.testing.assert_allclose(gx.numpy(), xg, atol=2e-4)
    np.testing.assert_allclose(gy.numpy(), yg, atol=2e-4)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=0, atol=1e-6)


def test_deproject_depth_with_distortion_matches_jax():
    import dataclasses

    j_intr = jd.Intrinsics(**_INTR)
    intr = intrinsics_from_dict(dataclasses.asdict(j_intr))
    assert intr.coeffs == j_intr.coeffs
    depth = np.random.default_rng(2).integers(0, 4000, (48, 64)).astype(np.uint16)
    want = np.asarray(jd.deproject_depth(jnp.asarray(depth), j_intr, 0.001))
    got = td.deproject_depth(t(depth.astype(np.int32)), intr, 0.001).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    plain = td.deproject_depth(t(depth.astype(np.int32)), td.Intrinsics.simple(64, 48))
    assert np.abs(got - plain.numpy()).max() > 1e-3  # the coefficients act


def test_compose_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 5, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(compose(t(a), t(b)).numpy(),
                               np.asarray(j_compose(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("normals", [False, True])
def test_concatenate_matches_jax(normals):
    rng = np.random.default_rng(1)

    def cloud(n, seed):
        r = np.random.default_rng(seed)
        c = JCloud.from_numpy(r.normal(size=(n, 3)).astype(np.float32) + [0, 0, 3],
                              r.uniform(0, 255, (n, 3)).astype(np.float32),
                              capacity=n + 5, valid=r.random(n) > 0.3)
        if normals:
            c = JCloud(c.xyz, c.rgb, c.valid, jnp.asarray(
                rng.normal(size=(n + 5, 3)).astype(np.float32)))
        return c

    ja, jb = cloud(40, 2), cloud(30, 3)
    want = _np(j_concatenate(ja, jb))
    got = cloud_to_numpy(concatenate(cloud_from_numpy(_np(ja)), cloud_from_numpy(_np(jb))))
    assert got.keys() == want.keys() and ("normal" in got) == normals
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_kdtree_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    queries = rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)
    d2, idx = native.KDTree(pts).query(queries)
    w_d2, w_idx = jax_native().KDTree(pts).query(queries)
    np.testing.assert_array_equal(idx, w_idx)
    np.testing.assert_array_equal(d2, w_d2)
    brute = ((queries[:, None] - pts[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx, brute.argmin(1))
