"""The port's input side against the JAX package (CPU): the IMU
complementary filter, the IMU and static guesses, the synthetic IMU
stream, the 3/5 center crop and the replay capture loop, on seeded numpy
inputs and the 3-frame 80x60 sequence of tests/test_pipeline.py.

Tolerances:
  * filter thetas (``rotation_from_imu_stream``, ``RotationEstimator``,
    ``SyntheticSequence.thetas``) and the IMU guesses: atol 1e-6 (f32
    ``atan2``, ``sqrt`` and the 3x3 products may round an ulp apart
    between XLA and PyTorch, and XLA may contract the blend into FMAs);
  * the synthetic IMU stream, ``center_crop_3_5`` and the replay clouds:
    exact (the deprojection takes the f32 reciprocal of fx as XLA
    compiles the JAX package's capture path);
  * replay thetas: atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.capture.replay import ReplaySource as JReplay
from rspc_tpu.capture.replay import get_clouds as j_get_clouds
from rspc_tpu.capture.synthetic import SyntheticSequence as JSequence
from rspc_tpu.config import CaptureConfig as JCapture
from rspc_tpu.estimators import rotation as jrot
from rspc_tpu.ops import transform as jtf
from rspc_tpu.ops.deproject import Intrinsics as JIntrinsics
from rspc_tpu.registration.pairsteps import _imu_guesses as j_imu_guesses
from rspc_tpu_torch.capture.replay import ReplaySource, get_clouds
from rspc_tpu_torch.capture.synthetic import SyntheticSequence
from rspc_tpu_torch.config import CaptureConfig
from rspc_tpu_torch.estimators import rotation as trot
from rspc_tpu_torch.interop import cloud_from_numpy
from rspc_tpu_torch.ops import transform as ttf
from rspc_tpu_torch.ops.deproject import Intrinsics
from rspc_tpu_torch.registration.pairsteps import _imu_guesses


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores, where torch's spinning
    intra-op threads slow every worker down by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


W, H, N, YAW = 80, 60, 3, -0.07
ATOL = 1e-6


def _random_stream(seed, n=40):
    """Interleaved gyro/accel events, gyro-only at the start (before the
    first accel, gyro must only record its stamp), millisecond stamps."""
    rng = np.random.default_rng(seed)
    kinds = (rng.random(n) < 0.5).astype(np.int32)
    kinds[:4] = trot.GYRO
    data = rng.normal(0, 1, (n, 3)).astype(np.float32)
    data[kinds == trot.ACCEL] += np.float32([0.0, 9.81, 0.0])
    ts = np.cumsum(rng.uniform(1.0, 40.0, n)).astype(np.float32)
    return kinds, data, ts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_stream_matches_jax(seed):
    kinds, data, ts = _random_stream(seed)
    want_final, want_all = jrot.rotation_from_imu_stream(jrot.ImuSample.stream(kinds, data, ts))
    got_final, got_all = trot.rotation_from_imu_stream(
        trot.ImuSample.stream(kinds, data, ts, device="cpu"))
    np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_final.numpy(), np.asarray(want_final), rtol=0, atol=ATOL)
    mask = kinds == trot.ACCEL
    _, want_snap = jrot.rotation_from_imu_stream(
        jrot.ImuSample.stream(kinds, data, ts), snapshot_mask=jnp.asarray(mask))
    _, got_snap = trot.rotation_from_imu_stream(
        trot.ImuSample.stream(kinds, data, ts, device="cpu"), snapshot_mask=mask)
    np.testing.assert_allclose(got_snap.numpy(), np.asarray(want_snap), rtol=0, atol=ATOL)


def test_filter_first_sample_rules():
    """The first accel sets theta = (angle.x, PI, angle.z); gyro before it
    does not integrate; dt is in seconds from millisecond stamps."""
    est = trot.RotationEstimator(device="cpu")
    est.process_gyro([1.0, 2.0, 3.0], 100.0)
    np.testing.assert_array_equal(est.get_theta(), np.zeros(3, np.float32))
    est.process_accel([0.0, 0.0, 1.0])
    np.testing.assert_allclose(est.get_theta(), [0.0, np.pi, 0.0], atol=ATOL)
    est.process_gyro([0.0, 0.5, 0.0], 1100.0)  # 1 s after the last gyro stamp
    np.testing.assert_allclose(est.get_theta(), [0.0, np.pi - 0.5, 0.0], atol=ATOL)


def test_rotation_estimator_matches_jax():
    kinds, data, ts = _random_stream(5, 24)
    j, t = jrot.RotationEstimator(), trot.RotationEstimator(device="cpu")
    for k, d, s in zip(kinds, data, ts):
        if k == trot.GYRO:
            j.process_gyro(d, float(s))
            t.process_gyro(d, float(s))
        else:
            j.process_accel(d)
            t.process_accel(d)
        np.testing.assert_allclose(t.get_theta(), j.get_theta(), rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def sequences():
    kw = dict(n_frames=N, yaw_step=YAW)
    return (JSequence(intr=JIntrinsics.simple(W, H), **kw),
            SyntheticSequence(intr=Intrinsics.simple(W, H), **kw))


def test_synthetic_imu_stream_matches(sequences):
    jseq, tseq = sequences
    (js, jsnap), (ts, tsnap) = jseq.imu_stream(), tseq.imu_stream(device="cpu")
    np.testing.assert_array_equal(tsnap, jsnap)
    np.testing.assert_array_equal(ts.kind.numpy(), np.asarray(js.kind))
    np.testing.assert_array_equal(ts.data.numpy(), np.asarray(js.data))
    np.testing.assert_array_equal(ts.ts.numpy(), np.asarray(js.ts))
    got, want = tseq.thetas(device="cpu"), jseq.thetas()
    assert got.shape == (N, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the filter's rebased yaw is minus the trajectory's
    np.testing.assert_allclose(got[:, 1] - got[0, 1], -np.arange(N) * YAW, atol=1e-5)


@pytest.mark.parametrize("use_ndt", [False, True])
def test_imu_guesses_match_jax(use_ndt):
    thetas = np.random.default_rng(3).normal(0, 0.3, (5, 3)).astype(np.float32)
    want = np.asarray(j_imu_guesses(jnp.asarray(thetas), use_ndt))
    got = _imu_guesses(torch.from_numpy(thetas), use_ndt).numpy()
    assert got.shape == (4, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_guess_builders_match_jax():
    thetas = np.random.default_rng(4).normal(0, 0.5, (4, 3)).astype(np.float32)
    t = torch.from_numpy(thetas)
    rel = ttf.relative_thetas(t).numpy()
    np.testing.assert_array_equal(rel[0], thetas[0])  # theta_0 is not rebased
    np.testing.assert_array_equal(rel, np.asarray(jtf.relative_thetas(jnp.asarray(thetas))))
    for fn in ("imu_guess_full", "imu_guess_y"):
        np.testing.assert_allclose(getattr(ttf, fn)(t).numpy(),
                                   np.asarray(jax.vmap(getattr(jtf, fn))(jnp.asarray(thetas))),
                                   rtol=0, atol=ATOL)
    np.testing.assert_allclose(ttf.static_y_guess(-0.3).numpy(),
                               np.asarray(jtf.static_y_guess(-0.3)), rtol=0, atol=ATOL)
    r = np.random.default_rng(5).normal(0, 1, (2, 3, 3)).astype(np.float32)
    v = np.random.default_rng(6).normal(0, 1, (2, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ttf.make_rigid(torch.from_numpy(r), torch.from_numpy(v)).numpy(),
        np.asarray(jtf.make_rigid(jnp.asarray(r), jnp.asarray(v))))


def test_center_crop_matches_jax(sequences):
    jseq = sequences[0]
    jc = jseq.clouds()[1]
    fields = {k: np.asarray(getattr(jc, k)) for k in ("xyz", "rgb", "valid")}
    want = jc.center_crop_3_5()
    got = cloud_from_numpy(fields, organized=True).center_crop_3_5()
    assert (got.height, got.width) == (36, 48)
    for k in ("xyz", "rgb", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    batch = cloud_from_numpy({k: np.stack([v, v]) for k, v in fields.items()},
                             organized=True).center_crop_3_5()
    np.testing.assert_array_equal(batch.xyz[1].numpy(), np.asarray(want.xyz))
    odd = cloud_from_numpy({k: v[:59] for k, v in fields.items()}, organized=True)
    with pytest.raises(ValueError, match="divisible by 5"):
        odd.center_crop_3_5()


def _recording(jseq, spacing_ms=None):
    """A replay recording of the JAX-rendered frames built as
    ``rspc_tpu/cli.py::_source`` builds it, optionally with other frame
    stamps (to exercise the 2 s throttle)."""
    depth, color = zip(*[(np.asarray(d), np.asarray(c)) for d, c in jseq.frames()])
    stream, snap = jseq.imu_stream()
    ts = np.asarray(stream.ts)[snap]
    if spacing_ms is not None:
        ts = (1000.0 + np.cumsum([0.0] + list(spacing_ms))).astype(np.float32)
    i = jseq.intr
    return {
        "depth": np.stack(depth), "color": np.stack(color), "ts": ts,
        "gyro": np.asarray(stream.data)[snap - 1],
        "accel": np.asarray(stream.data)[snap],
        "intr": np.asarray([i.width, i.height, i.fx, i.fy, i.ppx, i.ppy], np.float32),
    }


@pytest.mark.parametrize("crop,bgr,spacing", [
    (True, True, None),          # CaptureConfig(): the v1 capture
    (False, False, None),        # the v2 capture's full frames
    (True, True, (2500.0, 900.0)),  # the third frameset is inside the throttle
])
def test_replay_get_clouds_matches_jax(sequences, tmp_path, crop, bgr, spacing):
    rec = _recording(sequences[0], spacing)
    jcfg = JCapture(center_crop=crop, bgr_color=bgr)
    tcfg = CaptureConfig(center_crop=crop, bgr_color=bgr)
    want, want_t = j_get_clouds(JReplay(rec), N, jcfg)
    path = tmp_path / "rec.npz"
    ReplaySource.save(path, rec["depth"], rec["color"], rec["ts"], rec["gyro"],
                      rec["accel"], ReplaySource(rec).intr)
    got, got_t = get_clouds(ReplaySource(path), N, tcfg, device="cpu")
    assert len(got) == len(want) == (2 if spacing else N)
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=ATOL)
    for g, w in zip(got, want):
        assert g.xyz.device.type == "cpu"
        for k in ("xyz", "rgb", "valid"):
            np.testing.assert_array_equal(getattr(g, k).numpy(), np.asarray(getattr(w, k)))


def test_replay_thetas_are_the_filter_run(sequences):
    """``get_clouds``'s thetas equal ``SyntheticSequence.thetas()`` on a
    recording of the same stream (what chip_smoke.py checks on the card)."""
    _, thetas = get_clouds(ReplaySource(_recording(sequences[0])), N, CaptureConfig(),
                           device="cpu")
    np.testing.assert_allclose(thetas, sequences[1].thetas(device="cpu"), rtol=0, atol=ATOL)


def test_capture_config_copy_matches():
    assert dataclasses.asdict(CaptureConfig()) == dataclasses.asdict(JCapture())
