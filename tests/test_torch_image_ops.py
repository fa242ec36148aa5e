"""Image-space ops of the port against the JAX package (CPU, plain
versions): correlation, box sums, normals, Canny, hysteresis (kernel B3's
plain version) and edge extraction, on a JAX-rendered 160x120 frame and
on seeded random masks.

Tolerances:
  * conv2d_same / box_sum / estimate_normals: atol 1e-5 (different
    reduction order in the cumulative sums and norms);
  * hysteresis: exact (a boolean closure);
  * canny: exact against the JAX package evaluated op by op
    (``jax.disable_jit``, plain IEEE f32 like the port's kernels), and,
    against the jitted JAX program, equal up to pixels whose magnitude lies
    within 1e-4 relative of a threshold or of an NMS neighbour: XLA's CPU
    fusion contracts multiply-adds into FMAs, which breaks exact NMS ties
    on flat texture differently. The test bounds the port's edges between
    the hysteresis of the JAX masks with those pixels forced off and
    forced on (hysteresis is monotone in its masks);
  * extract_edge_features: same valid set and order as the op-by-op JAX
    reference; normals atol 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.capture.synthetic import SyntheticSequence
from rspc_tpu.config import EdgeConfig as JEdgeConfig
from rspc_tpu.ops.deproject import Intrinsics
from rspc_tpu.ops.edges import extract_edge_features as j_extract
from rspc_tpu.ops.normals import estimate_normals as j_normals
from rspc_tpu_torch.config import EdgeConfig
from rspc_tpu_torch.interop import cloud_from_numpy
from rspc_tpu_torch.ops import canny as tcanny
from rspc_tpu_torch.ops import image as timage
from rspc_tpu_torch.ops.edges import _frame_inputs, extract_edge_features
from rspc_tpu_torch.ops.normals import estimate_normals

jcanny = importlib.import_module("rspc_tpu.ops.canny")
jimage = importlib.import_module("rspc_tpu.ops.image")

EDGE = dict(max_edge_points=4096, edge_types=("rgb_canny",))


@pytest.fixture(scope="module")
def frame():
    seq = SyntheticSequence(n_frames=2, yaw_step=-0.08,
                            intr=Intrinsics.simple(160, 120))
    return seq.clouds()[1]


def _port_cloud(c):
    return cloud_from_numpy(
        {k: np.asarray(getattr(c, k)) for k in ("xyz", "rgb", "valid")},
        organized=True,
    )


def _intensity(c):
    return np.array(jnp.mean(c.rgb, axis=-1))


def test_conv2d_same_matches(frame):
    img = _intensity(frame)
    for kern in (jimage.gaussian_kernel_3x3(1.0), jimage.SOBEL_X, jimage.SOBEL_Y):
        want = np.asarray(jimage.conv2d_same(jnp.asarray(img), kern))
        got = timage.conv2d_same(torch.from_numpy(img), kern).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(37, 53), (24, 31, 3)])
def test_box_sum_and_shift_match(shape):
    rng = np.random.default_rng(3)
    img = rng.normal(size=shape).astype(np.float32)
    for r in (1, 2, 5):
        want = np.asarray(jimage.box_sum(jnp.asarray(img), r))
        got = timage.box_sum(torch.from_numpy(img), r).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for dr, dc in ((0, 3), (-2, 1), (5, -4), (0, -40)):
        want = np.asarray(jimage.shift2d(jnp.asarray(img), dr, dc))
        np.testing.assert_array_equal(
            timage.shift2d(torch.from_numpy(img), dr, dc).numpy(), want
        )


def test_estimate_normals_matches(frame):
    want_n, want_ok = j_normals(frame, JEdgeConfig())
    got_n, got_ok = estimate_normals(_port_cloud(frame), EdgeConfig())
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=0, atol=1e-5)


def _random_masks(seed, shape, p_weak, p_strong):
    rng = np.random.default_rng(seed)
    weak = rng.random(shape) < p_weak
    strong = weak & (rng.random(shape) < p_strong)
    strong[0, 0] = True  # a strong pixel outside the weak mask
    return strong, weak


@pytest.mark.parametrize("seed,shape,p_weak", [
    (7, (64, 256), 0.25), (8, (48, 96), 0.45), (9, (33, 70), 0.6),
])
def test_hysteresis_exact_vs_xla_and_pallas(seed, shape, p_weak):
    strong, weak = _random_masks(seed, shape, p_weak, 0.05)
    got = tcanny._hysteresis(torch.from_numpy(strong), torch.from_numpy(weak)).numpy()
    want_xla = np.asarray(jcanny._hysteresis(jnp.asarray(strong), jnp.asarray(weak)))
    want_pallas = np.asarray(jcanny._hysteresis_pallas(
        jnp.asarray(strong), jnp.asarray(weak), interpret=True))
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_pallas)


def test_hysteresis_batch_is_per_frame():
    masks = [_random_masks(s, (40, 72), 0.4, 0.04) for s in range(3)]
    strong = torch.from_numpy(np.stack([m[0] for m in masks]))
    weak = torch.from_numpy(np.stack([m[1] for m in masks]))
    got = tcanny._hysteresis(strong, weak)
    for i in range(3):
        assert torch.equal(got[i], tcanny._hysteresis(strong[i], weak[i]))


def test_hysteresis_cuda_refuses_cpu_tensors():
    s = torch.zeros((1, 8, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tcanny.hysteresis_cuda(s, s)


def test_canny_exact_vs_op_by_op_jax(frame):
    img = _intensity(frame)
    with jax.disable_jit():
        want = np.asarray(jcanny.canny(jnp.asarray(img), 40.0, 100.0))
    got = tcanny.canny(torch.from_numpy(img), 40.0, 100.0).numpy()
    assert want.sum() > 500
    np.testing.assert_array_equal(got, want)


def test_canny_bounded_by_jitted_jax(frame):
    img = jnp.asarray(_intensity(frame))
    low, high, rel = 40.0, 100.0, 1e-4

    @jax.jit
    def magnitudes(x):
        s = jimage.conv2d_same(x, jimage.gaussian_kernel_3x3(1.0))
        gx = jimage.conv2d_same(s, jimage.SOBEL_X)
        gy = jimage.conv2d_same(s, jimage.SOBEL_Y)
        return jnp.sqrt(gx * gx + gy * gy), gx, gy

    mag, gx, gy = (np.asarray(a) for a in magnitudes(img))
    keep = np.asarray(jcanny._nms(jnp.asarray(mag), jnp.asarray(gx), jnp.asarray(gy)))
    # NMS ties: a pixel within `rel` of any of its 8 neighbours' magnitudes
    tie = np.zeros(mag.shape, bool)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr or dc:
                nb = np.asarray(jimage.shift2d(jnp.asarray(mag), dr, dc))
                tie |= np.abs(mag - nb) <= rel * np.maximum(mag, 1.0)
    near = lambda t: np.abs(mag - t) <= rel * t
    unsure_w = (tie & (mag > low * (1 - rel))) | near(low)
    unsure_s = (tie & (mag > high * (1 - rel))) | near(high)
    mag_nms = np.where(keep, mag, 0.0)
    strong, weak = mag_nms > high, mag_nms > low
    hyst = lambda s, w: np.asarray(jcanny._hysteresis(jnp.asarray(s), jnp.asarray(w)))
    lower = hyst(strong & ~unsure_s & ~unsure_w, weak & ~unsure_w)
    upper = hyst(strong | unsure_s, weak | unsure_w)
    want = np.asarray(jax.jit(jcanny.canny)(img))
    got = tcanny.canny(torch.from_numpy(np.array(img)), low, high).numpy()
    assert (lower <= want).all() and (want <= upper).all()
    assert (lower <= got).all(), int((lower & ~got).sum())
    assert (got <= upper).all(), int((got & ~upper).sum())


def test_extract_edge_features_matches(frame):
    """Reference assembled from the JAX package's own pieces, evaluated op
    by op: the jitted mean intensity (XLA multiplies by the f32 reciprocal
    of 3, and so does the port), Canny, the integral-image normals, the
    block-shuffle priority and the stable key sort of
    ``rspc_tpu/ops/edges.py::extract_edge_features``."""
    jedges = importlib.import_module("rspc_tpu.ops.edges")
    cfg = JEdgeConfig(**EDGE)
    intensity = jax.jit(lambda rgb: jnp.mean(rgb, axis=-1))(frame.rgb)
    with jax.disable_jit():
        edge = jcanny.canny(intensity, cfg.canny_low_threshold,
                            cfg.canny_high_threshold)
        normals, _ = j_normals(frame, cfg)
        flat = frame.flatten()
        sel = edge.reshape(-1) & flat.valid
        keys = jnp.where(sel, jedges._shuffle_priority(sel.shape[0]), 2**31 - 1)
        order = np.asarray(jnp.argsort(keys, stable=True))[: cfg.max_edge_points]
    want_valid = np.asarray(sel)[order]
    got = extract_edge_features(_port_cloud(frame), EdgeConfig(**EDGE))
    v = got.valid.numpy()
    np.testing.assert_array_equal(v, want_valid)
    assert v.sum() > 500
    np.testing.assert_array_equal(got.xyz.numpy()[v], np.asarray(flat.xyz)[order][v])
    np.testing.assert_array_equal(got.rgb.numpy()[v], np.asarray(flat.rgb)[order][v])
    np.testing.assert_allclose(
        got.normal.numpy()[v], np.asarray(normals).reshape(-1, 3)[order][v],
        rtol=0, atol=1e-5,
    )
    # the jitted extractor differs only by the NMS ties its FMA-contracted
    # gradients break (see test_canny_bounded_by_jitted_jax)
    jit_count = int(np.asarray(j_extract(frame, cfg).valid).sum())
    assert abs(jit_count - int(v.sum())) < 0.15 * v.sum()


def test_edge_masks_feed_the_batched_hysteresis(frame):
    port = _port_cloud(frame)
    _, _, strong, weak = _frame_inputs(port, EdgeConfig(**EDGE))
    assert strong.dtype == torch.bool and strong.shape == (120, 160)
    assert bool((strong <= weak).all())


def test_unported_edge_classes_raise(frame):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        extract_edge_features(_port_cloud(frame), EdgeConfig())
