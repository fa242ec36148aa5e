"""Image-space ops of the port against the JAX package (CPU, plain
versions): correlation, box sums, normals, Canny, hysteresis (kernel B3's
plain version) and edge extraction, on a JAX-rendered 160x120 frame and
on seeded random masks.

Tolerances:
  * conv2d_same / box_sum / estimate_normals: atol 1e-5 (different
    reduction order in the cumulative sums and norms);
  * hysteresis: exact (a boolean closure), on random masks and on every
    ``ops/hysteresis_check.py`` case at 48x64, also against a
    ``scipy.ndimage.label`` oracle of the component identity;
  * canny: the port rounds its gradients as the JAX package's jitted
    program does (XLA on the CPU contracts the multiply-adds of the
    smoothing, the Sobel passes and the magnitude into FMAs), which
    decides the exact NMS ties of flat texture. Exact against the JAX
    package's NMS, thresholds and hysteresis evaluated op by op
    (``jax.disable_jit``) on gradients computed in numpy with those FMAs
    (each a product exact in f64, rounded once); against the jitted JAX
    program, equal up to pixels whose magnitude lies within 1e-4
    relative of a threshold or of an NMS neighbour (the test bounds the
    port's edges between the hysteresis of the JAX masks with those
    pixels forced off and forced on; hysteresis is monotone in its
    masks), and at most a tenth as far from it as the JAX package
    evaluated op by op, which keeps both pixels of every tie;
  * extract_edge_features: same valid set and order as the reference
    assembled op by op from the JAX package's pieces on those gradients;
    normals atol 1e-5.
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
from rspc_tpu_torch.ops.hysteresis_check import hysteresis_cases, hysteresis_truth
from rspc_tpu_torch.ops.normals import estimate_normals


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores, where torch's spinning
    intra-op threads slow every worker down by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.mark.parametrize("size", [3, 5])
def test_conv2d_same_full_rank_kernel_matches(frame, size):
    """A kernel that is not rank 1 runs as one convolution of the
    edge-padded image, against the JAX package's
    ``lax.conv_general_dilated`` (atol 1e-5 of the output's largest
    magnitude: f32 sums of nine or 25 products of intensities up to
    255 round at a few 1e-5 of their scale)."""
    img = _intensity(frame)
    kern = np.random.default_rng(size).normal(size=(size, size)).astype(np.float32)
    assert np.linalg.matrix_rank(kern) == size
    want = np.asarray(jimage.conv2d_same(jnp.asarray(img), kern))
    got = timage.conv2d_same(torch.from_numpy(img), kern).numpy()
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


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


CASE_H, CASE_W = 48, 64


@pytest.mark.parametrize("case", [c[0] for c in hysteresis_cases(CASE_H, CASE_W)])
def test_hysteresis_adversarial_cases(case):
    """The port's batched hysteresis, the JAX package's XLA fixpoint and
    its Pallas kernel (interpreted) frame by frame, and the components of
    ``strong | weak`` that hold a strong pixel: all the same bits."""
    _, strong, weak = next(c for c in hysteresis_cases(CASE_H, CASE_W) if c[0] == case)
    got = tcanny._hysteresis(torch.from_numpy(strong), torch.from_numpy(weak)).numpy()
    np.testing.assert_array_equal(got, hysteresis_truth(strong, weak))
    for s, w, g in zip(strong, weak, got):
        want_xla = np.asarray(jcanny._hysteresis(jnp.asarray(s), jnp.asarray(w)))
        want_pallas = np.asarray(jcanny._hysteresis_pallas(
            jnp.asarray(s), jnp.asarray(w), interpret=True))
        np.testing.assert_array_equal(g, want_xla)
        np.testing.assert_array_equal(g, want_pallas)


@pytest.mark.parametrize("frames,h,w,tiles", [
    (10, 480, 640, (15, 20)), (10, 720, 1280, (23, 40)), (1, 37, 33, (2, 2)),
    (2, 1, 640, (1, 20)), (2, 480, 1, (15, 1)), (1, 2000, 2000, (63, 63)),
    (1, 32, 32, (1, 1)), (3, 33, 31, (2, 1)),
])
def test_hysteresis_plan(frames, h, w, tiles):
    """Kernel B3's plan: the fewest 32x32 tiles that cover a frame, and
    scratch for 4 words of border bits per tile of the batch and a label
    per pixel."""
    p = tcanny.plan(frames, h, w)
    assert (p.tiles_y, p.tiles_x) == tiles
    assert (p.tiles_y - 1) * tcanny.TILE < h <= p.tiles_y * tcanny.TILE
    assert (p.tiles_x - 1) * tcanny.TILE < w <= p.tiles_x * tcanny.TILE
    assert p.tiles == frames * p.tiles_y * p.tiles_x
    assert p.scratch == 4 * p.tiles + frames * h * w


def test_hysteresis_plan_refuses_2_to_the_31_pixels():
    """Keys are a flat index with bit 31 as a flag."""
    assert tcanny.plan(1, 46340, 46341).scratch - 4 * 1449 * 1449 == 46340 * 46341 < 2**31
    assert tcanny.plan(2, 2**15, 2**15 - 1).tiles == 2 * 1024 * 1024
    for shape in ((2, 2**15, 2**15), (1, 2**16, 2**15), (3, 30000, 30000)):
        with pytest.raises(ValueError, match="2\\*\\*31"):
            tcanny.plan(*shape)


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


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32 (an f32 product is exact in f64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + c).astype(np.float32)


def _fused_conv(img, kernel):
    """``rspc_tpu/ops/image.py::conv2d_same`` of a rank-1 kernel in numpy,
    each pass's multiply-adds fused as XLA on the CPU fuses them: of the
    first two products the one by a negative tap is rounded and the other
    fused (the first when the signs agree), the third fused last."""
    u, sv, vt = np.linalg.svd(np.asarray(kernel, np.float64))
    kv = (u[:, 0] * np.sqrt(sv[0])).astype(np.float32)
    kr = (vt[0] * np.sqrt(sv[0])).astype(np.float32)
    h, w = img.shape
    p = np.pad(img, 1, mode="edge")

    def fused(terms):
        terms = [(k, x) for k, x in terms if k != 0.0]
        if terms[0][0] < 0 <= terms[1][0]:
            terms[:2] = terms[1::-1]
        acc = _fma(terms[0][1], terms[0][0], terms[1][1] * terms[1][0])
        for k, x in terms[2:]:
            acc = _fma(x, k, acc)
        return acc

    t = fused([(kv[i], p[i:i + h, :]) for i in range(3)])
    return fused([(kr[j], t[:, j:j + w]) for j in range(3)])


def _canny_reference(img, low, high):
    """Canny by the JAX package's NMS, double threshold and hysteresis
    evaluated op by op, on FMA-fused gradients (:func:`_fused_conv`, the
    magnitude ``sqrt(fma(gx, gx, gy * gy))``)."""
    s = _fused_conv(img, jimage.gaussian_kernel_3x3(1.0))
    gx, gy = _fused_conv(s, jimage.SOBEL_X), _fused_conv(s, jimage.SOBEL_Y)
    mag = np.sqrt(_fma(gx, gx, gy * gy))
    with jax.disable_jit():
        keep = jcanny._nms(jnp.asarray(mag), jnp.asarray(gx), jnp.asarray(gy))
        mag_nms = jnp.where(keep, jnp.asarray(mag), 0.0)
        return jcanny._hysteresis(mag_nms > high, mag_nms > low)


def test_canny_exact_vs_op_by_op_jax(frame):
    img = _intensity(frame)
    want = np.asarray(_canny_reference(img, 40.0, 100.0))
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
    with jax.disable_jit():
        op_by_op = np.asarray(jcanny.canny(img, low, high))
    assert (got != want).sum() <= 0.1 * (op_by_op != want).sum()


def test_extract_edge_features_matches(frame):
    """Reference assembled from the JAX package's own pieces, evaluated op
    by op: the jitted mean intensity (XLA multiplies by the f32 reciprocal
    of 3, and so does the port), Canny on FMA-fused gradients
    (:func:`_canny_reference`), the integral-image normals, the
    block-shuffle priority and the stable key sort of
    ``rspc_tpu/ops/edges.py::extract_edge_features``."""
    jedges = importlib.import_module("rspc_tpu.ops.edges")
    cfg = JEdgeConfig(**EDGE)
    intensity = jax.jit(lambda rgb: jnp.mean(rgb, axis=-1))(frame.rgb)
    edge = _canny_reference(np.asarray(intensity), cfg.canny_low_threshold,
                            cfg.canny_high_threshold)
    with jax.disable_jit():
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
    # the jitted extractor differs only where XLA fuses the gradients'
    # multiply-adds otherwise (see test_canny_bounded_by_jitted_jax)
    jit_count = int(np.asarray(j_extract(frame, cfg).valid).sum())
    assert abs(jit_count - int(v.sum())) < 0.15 * v.sum()


def test_edge_masks_feed_the_batched_hysteresis(frame):
    port = _port_cloud(frame)
    _, _, strong, weak = _frame_inputs(port, EdgeConfig(**EDGE))
    assert strong.dtype == torch.bool and strong.shape == (120, 160)
    assert bool((strong <= weak).all())


def test_unported_edge_classes_raise(frame):
    """All five label classes and the colour gradients on the edge cloud
    (``carry_cgrad``) are ported: each edge point carries the JAX
    package's tangent-plane intensity gradient at its pixel, computed on
    the port's normal image (atol 1e-5; the gradient's validity gates
    flip at a few pixels where the normals differ in their last bits, so
    the field itself is held on shared normals in test_torch_robust.py;
    the pixels and their order as in test_extract_edge_features_matches)."""
    jedges = importlib.import_module("rspc_tpu.ops.edges")
    jcg = importlib.import_module("rspc_tpu.ops.colorgrad")
    cfg = JEdgeConfig(**EDGE, carry_cgrad=True)
    intensity = jax.jit(lambda rgb: jnp.mean(rgb, axis=-1))(frame.rgb)
    edge = _canny_reference(np.asarray(intensity), cfg.canny_low_threshold,
                            cfg.canny_high_threshold)
    with jax.disable_jit():
        flat = frame.flatten()
        sel = edge.reshape(-1) & flat.valid
        keys = jnp.where(sel, jedges._shuffle_priority(sel.shape[0]), 2**31 - 1)
        order = np.asarray(jnp.argsort(keys, stable=True))[: cfg.max_edge_points]
    port = _port_cloud(frame)
    t_nrm, t_nv = estimate_normals(port, EdgeConfig(**EDGE))
    cg = np.asarray(jcg.color_gradients(frame, jnp.asarray(t_nrm.numpy()),
                                        jnp.asarray(t_nv.numpy()))).reshape(-1, 3)[order]
    got = extract_edge_features(port, EdgeConfig(**EDGE, carry_cgrad=True))
    v = got.valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(sel)[order])
    assert got.cgrad.shape == (EDGE["max_edge_points"], 3)
    assert (np.abs(cg[v]).sum(-1) > 0).mean() > 0.5
    np.testing.assert_allclose(got.cgrad.numpy()[v], cg[v], rtol=0, atol=1e-5)
