"""The port's cloud containers, transforms and buffer ops against the JAX
package on seeded numpy inputs. Integer/boolean outputs and gathered
rows must be equal exactly; transformed coordinates to atol 1e-6 (same
f32 products, possibly another summation order)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rspc_tpu.cloud as jcloud
from rspc_tpu.capture.synthetic import DepthNoise as JDepthNoise
from rspc_tpu.ops.transform import apply_transform_cloud as j_apply
from rspc_tpu.registration.bufferops import _as_unorganized as j_unorganized
from rspc_tpu.registration.bufferops import _block_append as j_block_append
from rspc_tpu.registration.bufferops import _rigid_inverse as j_inverse
from rspc_tpu.registration.bufferops import _stride_cloud as j_stride
from rspc_tpu.registration.bufferops import merge_append as j_merge
from rspc_tpu_torch import cloud as tcloud
from rspc_tpu_torch.capture.synthetic import DepthNoise, SyntheticSequence
from rspc_tpu_torch.interop import cloud_from_numpy, cloud_to_numpy
from rspc_tpu_torch.ops.transform import apply_transform_cloud
from rspc_tpu_torch.registration.bufferops import (
    _as_unorganized,
    _block_append,
    _rigid_inverse,
    _stride_cloud,
    merge_append,
)


def _np(c):
    return {k: np.asarray(getattr(c, k)) for k in ("xyz", "rgb", "valid", "normal")
            if getattr(c, k) is not None}


def _same(port, jax_cloud):
    want = _np(jax_cloud)
    got = cloud_to_numpy(port)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _random_cloud(seed, n, with_normal=True):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    valid = rng.random(n) < 0.6
    nrm = rng.normal(size=(n, 3)).astype(np.float32) if with_normal else None
    return jcloud.Cloud(jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(valid),
                        normal=None if nrm is None else jnp.asarray(nrm))


def test_from_numpy_marks_invalid_and_pads():
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    xyz[3] = np.nan
    xyz[7, 2] = 0.0
    rgb = rng.uniform(0, 255, (50, 3)).astype(np.float32)
    got, want = (tcloud.Cloud.from_numpy(xyz, rgb, capacity=64, device="cpu"),
                 jcloud.Cloud.from_numpy(xyz, rgb, capacity=64))
    _same(got, want)
    for a, b in zip(got.to_numpy(), want.to_numpy()):
        np.testing.assert_array_equal(a, b)
    org = xyz[:48].reshape(6, 8, 3)
    got = tcloud.OrganizedCloud.from_numpy(org, rgb[:48].reshape(6, 8, 3), device="cpu")
    want = jcloud.OrganizedCloud.from_numpy(org, rgb[:48].reshape(6, 8, 3))
    _same(got.flatten(), want.flatten())
    assert int(got.count()) == int(want.count())
    with pytest.raises(ValueError):
        tcloud.Cloud.from_numpy(xyz, capacity=10, device="cpu")


@pytest.mark.parametrize("cap", [None, 40, 300])
def test_compact_and_pad(cap):
    jc = _random_cloud(1, 200)
    _same(tcloud.compact(cloud_from_numpy(_np(jc)), cap), jcloud.compact(jc, cap))
    _same(cloud_from_numpy(_np(jc)).pad_to(260), jc.pad_to(260))


@pytest.mark.parametrize("gate", [None, True, False])
@pytest.mark.parametrize("dst_cap", [500, 120])  # roomy, and overflowing
def test_merge_append_matches(gate, dst_cap):
    dst = jcloud.compact(_random_cloud(2, dst_cap), dst_cap)
    src = _random_cloud(3, 150)
    jg = None if gate is None else jnp.asarray(gate)
    tg = None if gate is None else torch.tensor(gate)
    _same(merge_append(cloud_from_numpy(_np(dst)), cloud_from_numpy(_np(src)), gate=tg),
          j_merge(dst, src, gate=jg))


@pytest.mark.parametrize("gate", [None, True, False])
@pytest.mark.parametrize("offset", [0, 350])
def test_block_append_matches(gate, offset):
    dst, src = _random_cloud(7, 500), _random_cloud(8, 150)
    jg = None if gate is None else jnp.asarray(gate)
    tg = None if gate is None else torch.tensor(gate)
    tdst = cloud_from_numpy(_np(dst))
    got = _block_append(tdst, cloud_from_numpy(_np(src)), offset, gate=tg)
    assert got.xyz is tdst.xyz  # written in place
    _same(got, j_block_append(dst, src, offset, gate=jg))


def test_as_unorganized_matches():
    jc = _random_cloud(9, 48, with_normal=False)
    org = jcloud.OrganizedCloud(*(x.reshape(6, 8, *x.shape[1:]) for x in
                                  (jc.xyz, jc.rgb, jc.valid)))
    _same(_as_unorganized(cloud_from_numpy(_np(org), organized=True)), j_unorganized(org))
    flat = cloud_from_numpy(_np(jc))
    assert _as_unorganized(flat) is flat


def test_entry_points_default_to_the_card():
    for fn in (tcloud.Cloud.from_numpy, tcloud.OrganizedCloud.from_numpy,
               SyntheticSequence.frames, SyntheticSequence.clouds):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    # the parity harness keeps the CPU
    assert inspect.signature(cloud_from_numpy).parameters["device"].default == "cpu"


def test_stride_transform_and_inverse():
    jc = _random_cloud(4, 1000)
    _same(_stride_cloud(cloud_from_numpy(_np(jc)), 300), j_stride(jc, 300))
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = q * np.sign(np.linalg.det(q))
    t[:3, 3] = rng.normal(size=3)
    got = apply_transform_cloud(torch.from_numpy(t), cloud_from_numpy(_np(jc)))
    want = j_apply(jnp.asarray(t), jc)
    for k in ("xyz", "normal"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(_rigid_inverse(torch.from_numpy(t)).numpy(),
                               np.asarray(j_inverse(jnp.asarray(t))), atol=1e-6)


def test_depth_noise_is_bit_identical():
    depth = np.random.default_rng(6).integers(0, 5000, (40, 60)).astype(np.uint16)
    for kw in ({}, {"lateral_px": 0.7, "dropout": 0.05}):
        got = DepthNoise(**kw).apply(depth, np.random.default_rng(9))
        want = JDepthNoise(**kw).apply(depth, np.random.default_rng(9))
        np.testing.assert_array_equal(got, want)
