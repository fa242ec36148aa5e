"""The keypoint API's remaining options and the feature-quality harness
(``rspc_tpu_torch/tools/feature_quality.py``) against the JAX package
(CPU).

Tolerances (ceilings; measured on this CPU beside each):
  * ``detect_keypoints(first_octave=0)`` on the seeded aperiodic 160x120
    images of tests/test_torch_keypoints.py: valid mask equal, xy 1e-3
    (2.9e-4 measured), sigma 1e-4 (2.7e-5), score 1e-5 (1.3e-7);
  * ``compute_descriptors`` with ``first_octave=0``, and with
    ``sigma=None`` and the bare single-orientation return, on the JAX
    package's keypoints: 1e-4 (8.9e-7 and 4.1e-7), the validity of every
    orientation row equal;
  * ``match_descriptors`` with the scale gate: ``idx_b`` and ``good``
    identical, on tests/test_features.py's gate inputs and on a case
    whose even count of survivors makes the median the mean of the two
    middle log ratios (``jnp.nanmedian``; ``torch.nanmedian`` would take
    the lower one and drop half the matches);
  * the harness against the JAX package's ``tools/feature_quality.py``
    on the same ``cv2.warpPerspective`` frames: repeatability within
    0.02, ``n_matches`` within 3, inlier rate within 0.02 (measured: shift
    7.5e-5, 2 and 8.4e-5; scale1.12 0.0014, 0 and 0.0167). The detector's
    keypoints on frame 0 equal the JAX package's bit for bit; its
    descriptors do not (the jitted JAX gradients fuse their multiply-adds
    in an order that changes from level to level; see
    tests/test_torch_keypoints.py::test_get_clouds_new_matches_jax), and
    the synthetic room's near-tied orientation peaks turn a few of them;
  * the harness's own run (its renderer and warp) at ratio 0.3 meets
    the floors of tests/test_feature_quality.py;
  * ``warp_perspective`` against ``cv2.warpPerspective``: at most one
    gray level apart, on at most 16 of the 76,800 pixels of a warp
    (measured with OpenCV 5.0: 0, 1, 0 and 0; OpenCV 5 warps in float32,
    as the port does; earlier versions round the source position to
    1/32 px and would differ by up to 3 levels on about 3,000 pixels).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.ops import keypoints as jk
from rspc_tpu_torch.ops import keypoints as tk
from rspc_tpu_torch.tools import feature_quality as tfq
from test_torch_keypoints import _image
from tools import feature_quality as jfq


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores, where torch's spinning
    intra-op threads slow every worker down by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


t = lambda a: torch.from_numpy(np.array(a))

# tests/test_feature_quality.py's floors at ratio 0.3:
# (repeatability, n_matches, inlier rate)
FLOORS = {
    "shift": (0.9, 100, 0.95),
    "rotate8": (0.65, 30, 0.9),
    "scale1.12": (0.7, 35, 0.85),
    "perspective": (None, 30, 0.9),
}


@pytest.fixture(scope="module")
def images():
    return [_image(0), _image(0, shift=(2.5, 3.0))]


@pytest.fixture(scope="module")
def jax_keypoints0(images):
    """The JAX package's keypoints with ``first_octave=0``."""
    return [tuple(np.asarray(a) for a in jk.detect_keypoints(jnp.asarray(x), first_octave=0))
            for x in images]


@pytest.mark.parametrize("which", [0, 1])
def test_detect_first_octave_0_matches_jax(images, jax_keypoints0, which):
    xy, score, valid, sigma = tk.detect_keypoints(t(images[which]), first_octave=0)
    j_xy, j_score, j_valid, j_sigma = jax_keypoints0[which]
    np.testing.assert_array_equal(valid.numpy(), j_valid)
    assert j_valid.sum() > 50
    np.testing.assert_allclose(xy.numpy()[j_valid], j_xy[j_valid], rtol=0, atol=1e-3)
    np.testing.assert_allclose(sigma.numpy()[j_valid], j_sigma[j_valid], rtol=0, atol=1e-4)
    np.testing.assert_allclose(score.numpy(), j_score, rtol=0, atol=1e-5)
    # no upsampled octave: every sigma at or above the base level's 1.6
    assert sigma.numpy()[j_valid].min() >= 1.6 * 2 ** (0.5 / 3) - 1e-4


def test_first_octave_must_be_minus_1_or_0(images):
    with pytest.raises(ValueError, match="first_octave"):
        tk.detect_keypoints(t(images[0]), first_octave=1)


@pytest.mark.parametrize("opts", [
    {"first_octave": 0, "num_orientations": 3},
    {"sigma": None},
], ids=["first_octave_0", "sigma_none_bare"])
def test_compute_descriptors_options_match_jax(images, jax_keypoints0, opts):
    x = images[0]
    xy, _, valid, sigma = jax_keypoints0[0]
    opts = dict(opts)
    sig = sigma if opts.pop("sigma", True) is not None else None
    j_out = jk.compute_descriptors(jnp.asarray(x), jnp.asarray(xy), jnp.asarray(valid),
                                   None if sig is None else jnp.asarray(sig), **opts)
    out = tk.compute_descriptors(t(x), t(xy), t(valid), None if sig is None else t(sig), **opts)
    if opts.get("num_orientations", 1) == 1:
        assert isinstance(out, torch.Tensor) and out.shape == (xy.shape[0], 128)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=1e-4)
        assert (out.numpy()[~valid] == 0).all()
    else:
        (desc, valid_n), (j_desc, j_valid_n) = out, j_out
        np.testing.assert_array_equal(valid_n.numpy(), np.asarray(j_valid_n))
        np.testing.assert_allclose(desc.numpy(), np.asarray(j_desc), rtol=0, atol=1e-4)


def _unit(v):
    return (v / np.linalg.norm(v)).astype(np.float32)


def _gate_case(name):
    """(desc_a, desc_b, sigma_a, sigma_b, ratio, scale_gate, mutual_group)."""
    rng = np.random.default_rng(1)
    k = 9 if name in ("features", "off", "none_survive") else 8
    b = np.stack([_unit(rng.normal(size=128)) for _ in range(k)])
    a = np.stack([_unit(b[i] + 0.01 * rng.normal(size=128)) for i in range(k)])
    sa = np.full(k, 1.6, np.float32)
    if name == "even":
        # four matches at scale ratio 1 and four at 2: the median of
        # their log ratios is log(2) / 2, within log(1.5) of both halves
        sb = np.where(np.arange(k) < 4, 1.6, 3.2).astype(np.float32)
        return a, b, sa, sb, 0.8, 1.5, 0
    # tests/test_features.py::test_match_scale_gate: global scale 2x, one
    # keypoint's sigma contradicts it by 4x
    sb = np.full(k, 3.2, np.float32)
    sb[4] = 12.8
    ratio = 1e-3 if name == "none_survive" else 0.8
    return a, b, sa, sb, ratio, 0.0 if name == "off" else 1.5, 0


@pytest.mark.parametrize("name", ["features", "even", "off", "none_survive"])
def test_match_scale_gate_matches_jax(name):
    a, b, sa, sb, ratio, gate, mutual = _gate_case(name)
    va = np.ones(len(a), bool)
    vb = np.ones(len(b), bool)
    j_idx, j_good = jk.match_descriptors(
        jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb), ratio=ratio,
        sigma_a=jnp.asarray(sa), sigma_b=jnp.asarray(sb), scale_gate=gate, mutual_group=mutual)
    idx, good = tk.match_descriptors(t(a), t(va), t(b), t(vb), ratio=ratio, sigma_a=t(sa),
                                     sigma_b=t(sb), scale_gate=gate, mutual_group=mutual)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(good.numpy(), np.asarray(j_good))
    want = {"features": len(a) - 1, "even": len(a), "off": len(a), "none_survive": 0}[name]
    assert int(good.sum()) == want


def test_nanmedian_matches_jax():
    rng = np.random.default_rng(2)
    for n in (0, 1, 2, 5, 8, 31, 64):
        x = rng.normal(size=max(n, 1) + 7).astype(np.float32)
        x[rng.permutation(len(x))[: len(x) - n]] = np.nan
        got = tk._nanmedian(t(x)).item()
        want = float(jnp.nanmedian(jnp.asarray(x)))
        assert (np.isnan(got) and np.isnan(want)) if n == 0 else got == want, (n, got, want)


@pytest.fixture(scope="module")
def frames():
    """The JAX tool's frame 0 and its warps by ``cv2.warpPerspective``."""
    ga = jfq.test_images()[0]
    hs = jfq.homographies(ga.shape[1], ga.shape[0])
    return ga, hs, {n: cv2.warpPerspective(ga, h, (ga.shape[1], ga.shape[0]))
                    for n, h in hs.items()}


@pytest.fixture(scope="module")
def port_frame():
    """The harness's own frame 0, rendered by the port."""
    return tfq.test_images(device="cpu")[0]


def test_harness_frames_and_warps_match_jax(frames, port_frame):
    ga, hs, warped = frames
    np.testing.assert_array_equal(port_frame, ga)
    ours = tfq.homographies(ga.shape[1], ga.shape[0])
    assert ours.keys() == hs.keys()
    for name, hm in hs.items():
        np.testing.assert_allclose(ours[name], hm, rtol=0, atol=1e-12)
        d = np.abs(tfq.warp_perspective(ga, hm).astype(int) - warped[name].astype(int))
        assert d.max() <= 1 and (d > 0).sum() <= 16, (name, d.max(), (d > 0).sum())


@pytest.fixture(scope="module")
def port_row():
    """``tfq.measure_ours`` at ratio 0.3 on the CPU, each distinct input
    measured once (the harness's own warps of shift and scale1.12 equal
    cv2's, so the floors reuse those rows)."""
    rows = {}

    def measure(ga, gb, hm, **kw):
        key = (ga.tobytes(), gb.tobytes(), hm.tobytes(), tuple(sorted(kw.items())))
        if key not in rows:
            rows[key] = tfq.measure_ours(ga, gb, hm, ratio=0.3, device="cpu", **kw)
        return rows[key]
    return measure


@pytest.mark.parametrize("scale_gate", [0.0, 1.5])
@pytest.mark.parametrize("warp", ["shift", "scale1.12"])
def test_harness_matches_jax(frames, port_row, warp, scale_gate):
    ga, hs, warped = frames
    want = jfq.measure_ours(ga, warped[warp], hs[warp], ratio=0.3, scale_gate=scale_gate)
    got = port_row(ga, warped[warp], hs[warp], scale_gate=scale_gate)
    assert abs(got["repeatability"] - want["repeatability"]) <= 0.02, (got, want)
    assert abs(got["n_matches"] - want["n_matches"]) <= 3, (got, want)
    assert abs(got["inlier_rate"] - want["inlier_rate"]) <= 0.02, (got, want)


@pytest.mark.parametrize("warp", list(FLOORS))
def test_harness_meets_the_floors(port_frame, port_row, warp):
    ga = port_frame
    hm = tfq.homographies(ga.shape[1], ga.shape[0])[warp]
    r = port_row(ga, tfq.warp_perspective(ga, hm), hm, scale_gate=0.0)
    rep, matches, inliers = FLOORS[warp]
    assert rep is None or r["repeatability"] >= rep, r
    assert r["n_matches"] >= matches, r
    assert r["inlier_rate"] >= inliers, r
