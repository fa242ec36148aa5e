"""The port's main path end to end against the JAX package: the synthetic
renderer, deprojection, and the whole north-star registration (phase 1,
the NDT + guard + fine-ICP chain, the anchor refinement against frame 0,
the global cloud) on 3 JAX-rendered 160x120 frames with the north-star
configuration scaled to the frame size.

Tolerances: rendered depth equal except <= 0.1% of pixels off by 1 mm
(f32 ray-plane intersections rounded to millimetres land on the other
side of a half-millimetre in a few pixels); deprojected xyz atol 1e-5;
registration totals max-abs <= 5e-4 against JAX (phase 1 differs only at
exact NMS ties, which XLA's fused FMAs break differently; see
test_torch_image_ops.py), the same convergence flags, and both within
2e-2 of ground truth at this frame size."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.capture.synthetic import SyntheticSequence as JSequence
from rspc_tpu.capture.synthetic import render_frame as j_render
from rspc_tpu.ops.deproject import Intrinsics as JIntrinsics
from rspc_tpu.ops.deproject import rgbd_to_organized_cloud as j_deproject
from rspc_tpu.presets import north_star_config as j_north_star
from rspc_tpu.registration.schemes import NDTEdgeBasedRegistration as JReg
from rspc_tpu_torch.capture.synthetic import SyntheticSequence, render_frame
from rspc_tpu_torch.interop import cloud_from_numpy, config_from_dict
from rspc_tpu_torch.ops.deproject import Intrinsics, rgbd_to_organized_cloud
from rspc_tpu_torch.registration.schemes import NDTEdgeBasedRegistration

N, YAW, W, H = 3, -0.08, 160, 120
GT_BOUND = 2e-2


def _scaled_config():
    base = j_north_star()
    r = dataclasses.replace
    return r(
        base,
        icp=r(base.icp, max_source_points=2048),
        ndt=r(base.ndt, max_source_points=512, dense_grid_dim=16),
        edge=r(base.edge, max_edge_points=4096),
        voxel=r(base.voxel, max_points=2048),
        refine=r(base.refine, max_points=2048, anchor_max_points=1024),
    )


@pytest.fixture(scope="module")
def jax_run():
    seq = JSequence(n_frames=N, yaw_step=YAW, intr=JIntrinsics.simple(W, H))
    clouds = seq.clouds()
    cfg = _scaled_config()
    scheme = JReg(rads=YAW, config=cfg)
    result = scheme.registration(clouds)
    return seq, clouds, cfg, scheme, result


@pytest.fixture(scope="module")
def port_run(jax_run):
    _, clouds, cfg, _, _ = jax_run
    frames = [
        cloud_from_numpy({k: np.asarray(getattr(c, k)) for k in ("xyz", "rgb", "valid")},
                         organized=True)
        for c in clouds
    ]
    scheme = NDTEdgeBasedRegistration(
        rads=YAW, config=config_from_dict(dataclasses.asdict(cfg))
    )
    result = scheme.registration(frames)
    return scheme, result


def test_sequence_poses_match():
    j = JSequence(n_frames=4, yaw_step=YAW, intr=JIntrinsics.simple(W, H))
    t = SyntheticSequence(n_frames=4, yaw_step=YAW, intr=Intrinsics.simple(W, H))
    for i in range(4):
        np.testing.assert_allclose(t.poses[i], j.poses[i], atol=1e-6)
        np.testing.assert_allclose(t.gt_transform(i), j.gt_transform(i), atol=1e-6)


@pytest.mark.parametrize("frame", [0, 2])
def test_renderer_matches(frame):
    j = JSequence(n_frames=3, yaw_step=-0.2, intr=JIntrinsics.simple(W, H))
    jd, jc = (np.asarray(a) for a in j_render(jnp.asarray(j.poses[frame]), j.intr))
    td, tc = render_frame(torch.from_numpy(j.poses[frame]), Intrinsics.simple(W, H))
    td, tc = td.numpy(), tc.numpy()
    diff = np.abs(td.astype(np.int64) - jd.astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    assert (np.abs(tc.astype(int) - jc.astype(int)).max(-1) > 0).mean() <= 1e-2


def test_deprojection_matches(jax_run):
    seq = jax_run[0]
    depth, color = (np.asarray(a) for a in j_render(jnp.asarray(seq.poses[1]), seq.intr))
    want = j_deproject(jnp.asarray(depth), jnp.asarray(color), seq.intr, bgr=False)
    got = rgbd_to_organized_cloud(
        torch.from_numpy(depth.astype(np.int32)), torch.from_numpy(np.array(color)),
        Intrinsics.simple(W, H), bgr=False,
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), rtol=0, atol=1e-5)
    assert (got.rgb.numpy() != np.asarray(want.rgb)).any(-1).mean() <= 1e-2


def test_slice_totals_match_jax(jax_run, port_run):
    seq, _, _, jscheme, _ = jax_run
    tscheme, _ = port_run
    want = np.asarray(jscheme.total_transforms)
    got = tscheme.total_transforms.numpy()
    assert got.shape == (N - 1, 4, 4)
    assert np.abs(got - want).max() <= 5e-4, np.abs(got - want).max()
    for i in range(1, N):
        gt = seq.gt_transform(i)
        assert np.abs(want[i - 1] - gt).max() < GT_BOUND
        assert np.abs(got[i - 1] - gt).max() < GT_BOUND


def test_slice_convergence_matches_jax(jax_run, port_run):
    jscheme = jax_run[3]
    tscheme, _ = port_run
    assert [bool(f.converged) for _, f in tscheme.results] == [
        bool(f.converged) for _, f in jscheme.results
    ]
    np.testing.assert_array_equal(
        tscheme.anchor_accepted.numpy(), np.asarray(jscheme.anchor_accepted)
    )


def test_slice_global_cloud(jax_run, port_run):
    jresult = jax_run[4]
    _, tresult = port_run
    np.testing.assert_array_equal(tresult.valid.numpy(), np.asarray(jresult.valid))
    v = np.asarray(jresult.valid)
    assert np.isfinite(tresult.xyz.numpy()).all()
    np.testing.assert_allclose(tresult.xyz.numpy()[v], np.asarray(jresult.xyz)[v],
                               rtol=0, atol=5e-3)
