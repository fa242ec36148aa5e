"""The port's visual odometry against the JAX package (CPU): keypoints,
descriptors, matching, the DLT and RANSAC, the translation grid search,
and ``get_clouds_new`` on the 3-frame 80x60 replay recording of
tests/test_capture_cli.py.

The keypoint tests run on 160x120 seeded numpy images (random blobs,
rectangles and noise). The synthetic renderer's periodic texture gives
many extrema whose |DoG| agree to 1e-7, so their top-k order follows the
last bits of the blur: the port rounds the upsampling, the blur, the DoG
and the edge and sub-pixel fits as the jitted JAX detector does, with
its multiply-adds fused (``rspc_tpu_torch/ops/keypoints.py``).

Tolerances (ceilings; measured on this CPU beside each):
  * ``detect_keypoints``: valid mask, xy and scores equal, sigma 1e-6
    (2.4e-7 measured: the two packages' ``pow``); the Gaussian and DoG
    stacks equal (test_scale_space_matches_jitted_jax);
  * ``compute_descriptors`` on the JAX package's keypoints: 1e-4
    (1.3e-6 measured), the validity of every orientation row equal;
  * ``match_descriptors`` on the same descriptors: ``idx_b`` and
    ``good`` identical;
  * the DLT on Hartley-normalised 4-point sets: 1e-4 after scaling both
    to unit norm (7e-6 measured);
  * ``ransac_homography`` on a planted homography with 30% outliers:
    the same inlier mask (the draws differ; every all-inlier sample
    finds the same mask);
  * ``estimate_translation``: equal;
  * ``get_clouds_new``: clouds equal bit for bit; poses within 1e-3 with
    the JAX package's keypoints and descriptors swapped in, and within
    one step of the translation grid (0.01 m) end to end (see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.capture import odometry as j_odo
from rspc_tpu.capture.replay import ReplaySource as JReplay
from rspc_tpu.capture.synthetic import SyntheticSequence as JSequence
from rspc_tpu.estimators.translation import estimate_translation as j_translation
from rspc_tpu.ops import keypoints as jk
from rspc_tpu.ops import ransac as jr
from rspc_tpu.ops.deproject import Intrinsics as JIntrinsics
from rspc_tpu_torch.capture import odometry as t_odo
from rspc_tpu_torch.capture.replay import ReplaySource
from rspc_tpu_torch.estimators.translation import estimate_translation
from rspc_tpu_torch.ops import keypoints as tk
from rspc_tpu_torch.ops import ransac as tr


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores, where torch's spinning
    intra-op threads slow every worker down by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


H, W = 120, 160
N_ORI = 3


def _image(seed, shift=(0, 0)):
    """A textured 160x120 gray image (0..255 floats): Gaussian blobs,
    rectangles and noise from ``seed``, the scene shifted by ``shift``
    pixels (rows, columns) before the noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    yy, xx = yy - shift[0], xx - shift[1]
    img = np.full((H, W), 110.0)
    for _ in range(250):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        s = rng.uniform(1.0, 4.0)
        img += rng.uniform(-90, 90) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    for _ in range(30):
        y0, x0 = rng.integers(0, H - 10), rng.integers(0, W - 10)
        dy, dx = rng.integers(6, 30), rng.integers(6, 30)
        img += rng.uniform(-60, 60) * ((yy >= y0) & (yy < y0 + dy) & (xx >= x0) & (xx < x0 + dx))
    img += np.random.default_rng(seed + 100).normal(0, 2.0, (H, W))
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def images():
    return [_image(0), _image(0, shift=(2.5, 3.0))]


@pytest.fixture(scope="module")
def jax_keypoints(images):
    return [tuple(np.asarray(a) for a in jk.detect_keypoints(jnp.asarray(x))) for x in images]


@pytest.fixture(scope="module")
def jax_descriptors(images, jax_keypoints):
    out = []
    for x, (xy, _, valid, sigma) in zip(images, jax_keypoints):
        d, v = jk.compute_descriptors(jnp.asarray(x), jnp.asarray(xy), jnp.asarray(valid),
                                      jnp.asarray(sigma), num_orientations=N_ORI)
        out.append((np.asarray(d), np.asarray(v)))
    return out


t = lambda a: torch.from_numpy(np.array(a))


def test_top_k_and_argmax_keep_the_first_index_on_ties():
    x = np.array([3.0, 5.0, 5.0, 1.0, 5.0, 3.0, 0.0, 0.0], np.float32)
    vals, idx = tk._top_k(t(x), 6)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
    m = np.array([[1.0, 4.0, 4.0], [2.0, 2.0, 2.0]], np.float32)
    np.testing.assert_array_equal(tk._first_argmax(t(m), 1).numpy(), np.argmax(m, 1))
    np.testing.assert_array_equal(tk._first_argmax(t(m), 0).numpy(), np.argmax(m, 0))
    np.testing.assert_array_equal(tk._first_argmax(-t(m), 1).numpy(), np.argmin(m, 1))


def test_upsample_matches_jax_resize_at_the_borders(images):
    x = images[0] / 255.0
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2 * H, 2 * W), method="linear"))
    got = tk._upsample2(t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for edge in (got[0], got[-1], got[:, 0], got[:, -1]):
        assert np.isfinite(edge).all()
    np.testing.assert_allclose(got[[0, 1, -2, -1]], want[[0, 1, -2, -1]], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, [0, 1, -2, -1]], want[:, [0, 1, -2, -1]], rtol=0, atol=1e-6)


def test_upsample_matches_jitted_jax_resize_bit_for_bit(images):
    """Inside the jitted detector the resize is two dots, columns first,
    and the 1/255 scale a multiply by its f32 reciprocal."""
    for x in images:
        want = jax.jit(lambda g: jax.image.resize(g / 255.0, (2 * H, 2 * W), method="linear"))(
            jnp.asarray(x))
        np.testing.assert_array_equal(tk._upsample2(tk._unit(t(x))).numpy(), np.asarray(want))


@pytest.mark.parametrize("which", [0, 1])
def test_detect_keypoints_matches_jax(images, jax_keypoints, which):
    xy, score, valid, sigma = tk.detect_keypoints(t(images[which]))
    j_xy, j_score, j_valid, j_sigma = jax_keypoints[which]
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    assert j_valid.sum() > 50
    np.testing.assert_array_equal(xy.numpy()[j_valid], j_xy[j_valid])
    np.testing.assert_allclose(sigma.numpy()[j_valid], j_sigma[j_valid], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(score.numpy(), j_score)


def _jitted_octave(base, base_blur):
    """The JAX package's ``_detect_octave`` on ``base`` under ``jax.jit``,
    returning its outputs, every Gaussian level and the DoG stack. The
    levels are read by wrapping ``_blur`` and ``conv2d_same`` during the
    trace, so that each pass is an output of the program; see
    test_scale_space_matches_jitted_jax for what that changes."""
    def run(img):
        levels, passes, stacks = [], [], []
        blur, conv, jnp_mod = jk._blur, jk.conv2d_same, jk.jnp

        class _Stack:
            def __getattr__(self, name):
                return getattr(jnp_mod, name)

            def stack(self, xs, axis=0):
                stacks.append(jnp_mod.stack(xs, axis=axis))
                return stacks[-1]

        jk._blur = lambda x, sig: levels.append(blur(x, sig)) or levels[-1]
        jk.conv2d_same = lambda x, k: passes.append(conv(x, k)) or passes[-1]
        jk.jnp = _Stack()
        try:
            out = jk._detect_octave(img, 512, 3, 0.02, 10.0, base_blur=base_blur)
        finally:
            jk._blur, jk.conv2d_same, jk.jnp = blur, conv, jnp_mod
        return out, levels, stacks[0], passes
    out, levels, dog, _ = jax.jit(run)(jnp.asarray(base))
    return [np.asarray(a) for a in out], [np.asarray(g) for g in levels], np.asarray(dog)


@pytest.mark.parametrize("which", [0, 1])
def test_scale_space_matches_jitted_jax(images, which):
    """The port's Gaussian levels and DoG stack equal the jitted JAX
    detector's bit for bit at every octave (-1, 0, 1 at 160x120), and so
    do the octave's keypoints and next base (sigma to 1e-6: the two
    packages' ``pow``). The port rounds as XLA's CPU code does: the 1/255
    scale as a multiply, the resize's dots as fused multiply-adds, each
    blur pass's taps by ``ops/image.py::_contracted_sum``, the DoG as
    ``fma(s, c, -lower)`` with the upper level's last multiply fused, the
    edge test's and the sub-pixel fit's differences of products fused,
    and ``(r + 1)^2 * det * r`` as one constant times ``det``.

    Reading the levels makes each pass an output of the program. Without
    that, XLA recomputes the centre row of one level's column pass (sigma
    1.75 at the upsampled octave) inside the DoG's fusion, where it
    rounds otherwise at 184-236 of 76,800 pixels of each image here; the
    keypoints equal the JAX package's either way
    (test_detect_keypoints_matches_jax)."""
    base = tk._upsample2(tk._unit(t(images[which])))
    for octave, base_blur in ((-1, 1.0), (0, 1.6), (1, 1.6)):
        out, j_levels, j_dog = _jitted_octave(base.numpy(), base_blur)
        levels, dog = tk._scale_space(base, 3, base_blur)
        # a chained base is level 0 itself, not a blur of it
        assert len(levels) - len(j_levels) == (base_blur >= 1.6)
        for i, (g, j_g) in enumerate(zip(levels[len(levels) - len(j_levels):], j_levels)):
            np.testing.assert_array_equal(g.numpy(), j_g, err_msg=f"octave {octave} level {i}")
        np.testing.assert_array_equal(dog.numpy(), j_dog, err_msg=f"octave {octave}")
        got = tk._detect_octave(base, 512, 3, 0.02, 10.0, base_blur=base_blur)
        for name, a, b in zip(("xy", "score", "valid", "sigma", "next_base"), got, out):
            if name == "sigma":
                np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(a.numpy(), b, err_msg=f"octave {octave} {name}")
        base = got[4]


@pytest.mark.parametrize("which", [0, 1])
def test_compute_descriptors_matches_jax(images, jax_keypoints, jax_descriptors, which):
    xy, _, valid, sigma = jax_keypoints[which]
    desc, valid_n = tk.compute_descriptors(t(images[which]), t(xy), t(valid), t(sigma),
                                           num_orientations=N_ORI)
    j_desc, j_valid_n = jax_descriptors[which]
    np.testing.assert_array_equal(valid_n.numpy(), j_valid_n)
    np.testing.assert_allclose(desc.numpy(), j_desc, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mutual_group", [0, N_ORI])
def test_match_descriptors_matches_jax(jax_descriptors, mutual_group):
    (da, va), (db, vb) = jax_descriptors
    j_idx, j_good = jk.match_descriptors(
        jnp.asarray(da), jnp.asarray(va), jnp.asarray(db), jnp.asarray(vb), ratio=0.3,
        mutual_group=mutual_group)
    idx, good = tk.match_descriptors(t(da), t(va), t(db), t(vb), ratio=0.3,
                                     mutual_group=mutual_group)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(good.numpy(), np.asarray(j_good))
    assert good.sum() > 20  # the shifted pair matches


def _planted_homography():
    return np.array([[1.02, 0.03, 12.0], [-0.02, 0.98, -7.0], [1e-5, -2e-5, 1.0]], np.float64)


def _project(hm, pts):
    p = np.c_[pts, np.ones(len(pts))] @ hm.T
    return (p[:, :2] / p[:, 2:]).astype(np.float32)


def _hartley(pts):
    """Centre each 4-point set and scale it to a mean distance of sqrt(2)."""
    c = pts - pts.mean(axis=1, keepdims=True)
    return (c * np.sqrt(2) / np.linalg.norm(c, axis=-1).mean(axis=1)[:, None, None]
            ).astype(np.float32)


def test_dlt_matches_jax():
    """On Hartley-normalised sets. At raw pixel scale (0..640) the 8x9
    system is too ill-conditioned for f32: both packages' f32 DLTs stray
    from the float64 null vector by 5e-3 (median) and up to 1.8, each
    in its own way, so they cannot agree to 1e-4 there."""
    rng = np.random.default_rng(3)
    pix = rng.uniform(0, 640, (64, 4, 2))
    dst = _hartley(np.stack([
        _project(_planted_homography() + rng.normal(0, 1e-3, (3, 3)), s) for s in pix]))
    src = _hartley(pix)
    want = np.asarray(jax.vmap(jr._dlt_homography)(jnp.asarray(src), jnp.asarray(dst)))
    got = tr._dlt_homography(t(src), t(dst)).numpy()
    unit = lambda h: h / np.linalg.norm(h, axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(unit(got), unit(want), rtol=0, atol=1e-4)


def test_ransac_inliers_match_jax():
    rng = np.random.default_rng(5)
    k = 200
    src = rng.uniform(0, 640, (k, 2)).astype(np.float32)
    dst = _project(_planted_homography(), src)
    outlier = rng.random(k) < 0.3
    dst[outlier] = rng.uniform(0, 640, (int(outlier.sum()), 2)).astype(np.float32)
    valid = rng.random(k) < 0.9
    j_h, j_inl, j_n = jr.ransac_homography(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid))
    h, inl, n = tr.ransac_homography(t(src), t(dst), t(valid))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(j_inl))
    np.testing.assert_array_equal(inl.numpy(), valid & ~outlier)
    assert int(n) == int(j_n) and torch.isfinite(h).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_translation_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
    cmp = (ref + rng.uniform(-1, 1, 3) + rng.normal(0, 0.01, (40, 3))).astype(np.float32)
    theta = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
    w = (rng.random(40) < 0.7).astype(np.float32)
    for weights in (None, w):
        want = np.asarray(j_translation(jnp.asarray(ref), jnp.asarray(cmp), jnp.asarray(theta),
                                        weights=None if weights is None else jnp.asarray(weights)))
        got = estimate_translation(t(ref), t(cmp), t(theta),
                                   weights=None if weights is None else t(weights))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def replay_recording():
    intr = JIntrinsics.simple(80, 60)
    seq = JSequence(n_frames=3, yaw_step=-0.07, intr=intr)
    depths, colors = zip(*[(np.asarray(d), np.asarray(c)) for d, c in seq.frames()])
    stream, snap = seq.imu_stream()
    return {"depth": np.stack(depths), "color": np.stack(colors),
            "ts": np.asarray(stream.ts)[snap], "gyro": np.asarray(stream.data)[snap - 1],
            "accel": np.asarray(stream.data)[snap],
            "intr": np.asarray([intr.width, intr.height, intr.fx, intr.fy, intr.ppx, intr.ppy],
                               np.float32)}


def test_detect_keypoints_on_the_replay_frames(replay_recording):
    """The recording's checkerboard frames, whose extrema tie to 1e-7:
    the same valid mask, positions and scores as the JAX package."""
    for color in replay_recording["color"]:
        gray = color.astype(np.float32).mean(axis=-1)
        xy, score, valid, sigma = tk.detect_keypoints(t(gray))
        j_xy, j_score, j_valid, j_sigma = (np.asarray(a) for a in jk.detect_keypoints(jnp.asarray(gray)))
        np.testing.assert_array_equal(valid.numpy(), j_valid)
        assert j_valid.sum() > 50
        np.testing.assert_array_equal(xy.numpy()[j_valid], j_xy[j_valid])
        np.testing.assert_allclose(sigma.numpy()[j_valid], j_sigma[j_valid], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(score.numpy(), j_score)


@pytest.fixture(scope="module")
def jax_odometry(replay_recording, tmp_path_factory):
    return j_odo.get_clouds_new(JReplay(replay_recording), 3,
                                debug_dir=str(tmp_path_factory.mktemp("jax_matches")))


def _jax_features(monkeypatch):
    """Swap the JAX package's keypoints and descriptors into the port's
    odometry (computed on the port's gray images, returned as tensors)."""
    def wrap(fn):
        def call(gray, *args, **kw):
            out = fn(jnp.asarray(gray.numpy()), *(jnp.asarray(a.numpy()) for a in args), **kw)
            return tuple(torch.from_numpy(np.array(a)) for a in out)
        return call
    monkeypatch.setattr(t_odo, "detect_keypoints", wrap(jk.detect_keypoints))
    monkeypatch.setattr(t_odo, "compute_descriptors", wrap(jk.compute_descriptors))


@pytest.mark.parametrize("features", ["jax", "port"])
def test_get_clouds_new_matches_jax(replay_recording, jax_odometry, tmp_path, monkeypatch,
                                    features):
    """The replayed clouds equal bit for bit. With the JAX package's
    keypoints and descriptors swapped in, the poses agree within 1e-3.
    End to end, one pose may move by one step (0.01 m) of the
    translation grid: the port's keypoints equal the JAX package's on
    these frames (test_detect_keypoints_on_the_replay_frames), but not
    its descriptors. The checkerboard gives orientation histograms with
    near-equal peaks, and the jitted ``compute_descriptors`` fuses the
    blur's last multiply into the gradient's subtraction in a way that
    changes from level to level: on frame 0 of this recording, of the
    15 gradient levels, 8-14 round op by op, 1-4 and 7 fuse the
    subtracted product, 5-6 fuse the subtracted product in x and the
    other in y, and 0 none of the three exactly, so no one rounding of
    the port's ``_grad`` meets more than 8 of them (about 4,100-4,800 of
    4,800 pixels differ on each other level), and a few descriptors
    turn."""
    if features == "jax":
        _jax_features(monkeypatch)
    got = t_odo.get_clouds_new(ReplaySource(replay_recording), 3,
                               debug_dir=str(tmp_path), device="cpu")
    assert len(got) == len(jax_odometry) == 3
    tol = 1e-3 if features == "jax" else 0.01 + 1e-3
    for (c, pose), (jc, j_pose) in zip(got, jax_odometry):
        np.testing.assert_array_equal(c.xyz.numpy(), np.asarray(jc.xyz))
        np.testing.assert_array_equal(c.rgb.numpy(), np.asarray(jc.rgb))
        np.testing.assert_array_equal(c.valid.numpy(), np.asarray(jc.valid))
        np.testing.assert_allclose(pose, np.asarray(j_pose), rtol=0, atol=tol)
    for i in (1, 2):
        assert (tmp_path / f"matches-{i}.png").exists()
