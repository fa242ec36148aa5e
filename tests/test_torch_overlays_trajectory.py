"""The port's overlays (``viz/overlays.py``) and world-frame trajectory
renderer (``viz/trajectory.py``) against the JAX package (CPU).

Tolerances: the overlays equal bit for bit (numpy drawing; the IMU axes
rotate by the port's f32 rotation matrices, equal here to the last pixel
on every seeded angle). The trajectory render equals the JAX package's
image at every pixel where at most one point holds the minimum depth.
Where several do, the port takes the lowest point index (the cloud's
points, then the trajectory, then the frusta) and the JAX package
whichever its scatter keeps; those tie pixels are the ones that change
when the port renders the same points in reverse order. Images at 80x60
to 160x120.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.cloud import Cloud as JCloud
from rspc_tpu.viz import overlays as jo
from rspc_tpu.viz import trajectory as jt
from rspc_tpu_torch.interop import cloud_from_numpy, poses_from_numpy
from rspc_tpu_torch.viz import overlays as to
from rspc_tpu_torch.viz import trajectory as tt


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores, where torch's spinning
    intra-op threads slow every worker down by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_imu_axes_matches_jax(seed):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-3.2, 3.2, 3).tolist()
    accel = rng.normal(size=3).tolist() if seed else None
    for size in (64, 256):
        np.testing.assert_array_equal(to.render_imu_axes(theta, accel, size),
                                      jo.render_imu_axes(theta, accel, size))


def test_text_grid_and_mosaic_match_jax():
    assert to.pose_text([0.1, -2, 3.25], [0.5, 0, -1], [1, 2, 3]) == \
        jo.pose_text([0.1, -2, 3.25], [0.5, 0, -1], [1, 2, 3])
    assert to.pose_text([0, 0, 0], [0, 0, 0]) == jo.pose_text([0, 0, 0], [0, 0, 0])
    for n in range(1, 12):
        assert to.calc_grid(n) == jo.calc_grid(n)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (12, 16, 3), dtype=np.uint8) for _ in range(5)]
    np.testing.assert_array_equal(to.frames_mosaic(frames), jo.frames_mosaic(frames))


@pytest.mark.parametrize("fmt", ["rgb8", "rgba8", "bgr8", "y8", "y10bpack"])
def test_video_frame_to_rgb_matches_jax(fmt):
    rng = np.random.default_rng(4)
    shape = {"rgba8": (6, 8, 4), "y8": (6, 8), "y10bpack": (6, 8)}.get(fmt, (6, 8, 3))
    hi = 1024 if fmt == "y10bpack" else 256
    d = rng.integers(0, hi, shape).astype(np.uint16 if fmt == "y10bpack" else np.uint8)
    np.testing.assert_array_equal(to.video_frame_to_rgb(d, fmt), jo.video_frame_to_rgb(d, fmt))
    with pytest.raises(ValueError):
        to.video_frame_to_rgb(d, "z16")


def test_show_in_rect_and_keys_match_jax():
    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    for rect in [(0, 0, 200, 100), (10, 5, 50, 90), (150, 80, 100, 60)]:
        assert to.adjust_ratio(rect[2:], (40, 30)) == jo.adjust_ratio(rect[2:], (40, 30))
        a, b = np.zeros((120, 220, 3), np.uint8), np.zeros((120, 220, 3), np.uint8)
        to.show_in_rect(a, frame, rect)
        jo.show_in_rect(b, frame, rect)
        np.testing.assert_array_equal(a, b)
    keys, j_keys = to.KeyListener(), jo.KeyListener()
    for k in (65, 32):
        keys.on_key_release(k)
        j_keys.on_key_release(k)
    assert [keys.get_key(), keys.get_key()] == [j_keys.get_key(), j_keys.get_key()] == [32, -1]


def _scene(seed):
    """A red depth-camera cloud (+z forward) with duplicated points (depth
    ties), a three-vertex path and two camera poses in world coordinates."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.3, 0.3, (1500, 3)).astype(np.float32) + np.float32([0, 0, 1.0])
    pts[1000:1100] = pts[:100]
    rgb = rng.uniform(0, 255, (1500, 3)).astype(np.float32)
    valid = rng.random(1500) > 0.05
    traj = np.float32([[0, 0, -0.8], [0.2, -0.05, -1.0], [0.4, -0.1, -1.2]])
    frusta = []
    for x in (0.0, 0.3):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [x, 0.0, -0.9]
        frusta.append(m)
    return pts, rgb, valid, traj, frusta


@pytest.mark.parametrize("size,pose", [((160, 120), "flip"), ((80, 60), "quat")])
def test_render_trajectory_matches_jax_apart_from_ties(size, pose):
    width, height = size
    pts, rgb, valid, traj, frusta = _scene(0 if pose == "flip" else 1)
    if pose == "flip":
        kw = dict(pose=jt.DEPTH_TO_WORLD, extrinsics=np.eye(4, dtype=np.float32))
    else:
        kw = dict(pose=(np.float32([0.0, 0.9659258, 0.0, 0.2588190]), (0.3, 0.0, -0.2)))
    view = dict(yaw=10.0, pitch=-5.0, offset_y=2.0, width=width, height=height)
    want = jt.render_trajectory(JCloud.from_numpy(pts, rgb, valid=valid), traj,
                                frusta=frusta, **kw, **view)
    cloud = cloud_from_numpy({"xyz": pts, "rgb": rgb, "valid": valid})
    got = tt.render_trajectory(cloud, traj, frusta=frusta, **kw, **view)
    assert got.shape == (height, width, 3) and got.dtype == np.uint8

    # the same points in reverse order, through the port's world renderer
    pose_m = (jt.quat2mat(kw["pose"][0]) if isinstance(kw["pose"], tuple)
              else np.asarray(kw["pose"], np.float32))
    if isinstance(kw["pose"], tuple):
        pose_m[:3, 3] = kw["pose"][1]
    lines = [tt._polyline_points(traj)] + [tt._polyline_points(tt.frustum_lines(f))
                                           for f in frusta]
    posed = tt._apply_pose(torch.from_numpy(pts), pose_m).numpy()
    xyz = np.concatenate([posed] + lines)
    cols = np.concatenate([rgb] + [np.tile(np.float32(c), (len(p), 1)) for p, c in
                                   zip(lines, [tt.TRAJ_COLOR] + [tt.FRUSTUM_COLOR] * 2)])
    ok = np.concatenate([valid, np.ones(len(xyz) - len(pts), bool)])
    r = slice(None, None, -1)
    cam = {k: view[k] for k in ("yaw", "pitch", "offset_y", "width", "height")}
    fwd = tt._render_world(torch.from_numpy(xyz), torch.from_numpy(cols), torch.from_numpy(ok),
                           **cam).numpy()
    rev = tt._render_world(torch.from_numpy(xyz[r].copy()), torch.from_numpy(cols[r].copy()),
                           torch.from_numpy(ok[r].copy()), **cam).numpy()
    np.testing.assert_array_equal(fwd, got)
    ties = (fwd != rev).any(-1)
    assert ties.sum() <= 0.02 * width * height
    np.testing.assert_array_equal(got[~ties], want[~ties])
    green = (got[..., 1] > 200) & (got[..., 0] < 100) & (got[..., 2] < 100)
    assert green.sum() > 5 and (got != 153).any(-1).sum() > 200


def test_trajectory_helpers_match_jax():
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = jt.quat2mat([0.1, -0.2, 0.3, 0.927])[:3, :3]
    t[:3, 3] = [1, 2, 3]
    np.testing.assert_array_equal(tt.quat2mat([0.1, -0.2, 0.3, 0.927]),
                                  jt.quat2mat([0.1, -0.2, 0.3, 0.927]))
    np.testing.assert_array_equal(tt.frustum_lines(t), jt.frustum_lines(t))
    totals = np.stack([t, 2 * t])
    want = jt.trajectory_from_transforms(totals)
    np.testing.assert_array_equal(tt.trajectory_from_transforms(totals), want)
    np.testing.assert_array_equal(tt.trajectory_from_transforms(poses_from_numpy(totals)), want)
    np.testing.assert_array_equal(tt._polyline_points(want), jt._polyline_points(want))


def test_examples_run_on_the_cpu(tmp_path, monkeypatch):
    """``rspc_tpu_torch.examples``: the capture example writes an ASCII PCD
    of the synthetic 640x480 frame, the two viewers render it to PNG (the
    normals example with its two radius passes), all with
    ``device="cpu"``; without a card the default device exits 1, and so
    does a missing argument."""
    from rspc_tpu_torch.examples import capture, cloud_viewer, pcd_visualization
    from rspc_tpu_torch.io.pcd import load_pcd
    from rspc_tpu_torch.ops.voxel import voxel_downsample
    from rspc_tpu_torch.io.pcd import save_pcd

    monkeypatch.chdir(tmp_path)
    assert capture.main(["capture", "one.pcd"], device="cpu") == 0
    cloud = load_pcd(str(tmp_path / "samples" / "one.pcd"), device="cpu")
    assert int(cloud.count()) > 0.9 * 640 * 480
    save_pcd(str(tmp_path / "small.pcd"), voxel_downsample(cloud.flatten(), 0.05, 4096))
    assert cloud_viewer.main(["cloud_viewer", "small.pcd", "10", "-5"], device="cpu") == 0
    assert pcd_visualization.main(["pcd_visualization", "small.pcd"], device="cpu") == 0
    assert (tmp_path / "small.pcd.view.png").stat().st_size > 1000
    assert pcd_visualization.main(["pcd_visualization"], device="cpu") == 1
    if not torch.cuda.is_available():
        assert cloud_viewer.main(["cloud_viewer", "small.pcd"]) == 1
