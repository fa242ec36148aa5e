"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: without a CUDA card every test skips (the
decision is taken inside the fixture, never at import). Run on the card
with ``python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py``
(``--noconftest``: tests/conftest.py imports jax, which the port's machine
need not have);
``chip_smoke.py`` runs the same checks at the main path's shapes."""

from pathlib import Path

import numpy as np
import pytest
import torch

from rspc_tpu_torch import cuda_build
from rspc_tpu_torch.ops.canny import _hysteresis, _hysteresis_plain, hysteresis_cuda
from rspc_tpu_torch.ops.hysteresis_check import hysteresis_cases, hysteresis_truth
from rspc_tpu_torch.ops import nn as tnn
from rspc_tpu_torch.ops.nn import (
    nearest_neighbors,
    nearest_neighbors_cuda,
    nearest_neighbors_stream_cuda,
    nn_sweep,
)
from rspc_tpu_torch.ops.nn_check import adversarial_cases, run_nn_checks

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def test_nn_kernel_passes_nn_check(dev):
    def on_card(*arrays):
        d2, idx = nearest_neighbors_cuda(
            *(torch.from_numpy(np.array(a)).to(dev) for a in arrays))
        return d2.cpu().numpy(), idx.cpu().numpy()

    assert not run_nn_checks(on_card)


@pytest.mark.parametrize("n,m,live", [(1, 5, 5), (300, 2500, 2200), (4100, 9000, 9000)])
def test_nn_kernel_matches_plain(dev, n, m, live):
    rng = np.random.default_rng(n)
    tgt = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    tv = np.zeros(m, bool)
    tv[:live] = rng.random(live) < 0.7
    src = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    sv = rng.random(n) < 0.9
    args = [torch.from_numpy(a).to(dev) for a in (src, sv, tgt, tv)]
    before = cuda_build.LAUNCHES["nn_sweep"]
    d_k, i_k = nn_sweep(*args)
    assert cuda_build.LAUNCHES["nn_sweep"] == before + 1
    d_p, i_p = nearest_neighbors(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(d_p)
    assert torch.equal(torch.isfinite(d_k), fin)
    torch.testing.assert_close(d_k[fin], d_p[fin], rtol=1e-5, atol=1e-12)


def test_split_kernel_passes_nn_check(dev):
    def on_card(*arrays):
        d2, idx = nearest_neighbors_stream_cuda(
            *(torch.from_numpy(np.array(a)).to(dev) for a in arrays))
        return d2.cpu().numpy(), idx.cpu().numpy()

    assert not run_nn_checks(on_card)


@pytest.mark.parametrize("n,m,live", [(1, 5, 5), (300, 2500, 2200), (4100, 9000, 9000),
                                      (5000, 70_000, 20_000)])
def test_split_kernel_matches_plain_and_b1(dev, monkeypatch, n, m, live):
    """Routed through nn_sweep with STREAM_TARGET lowered; B2 equals B1
    bit for bit (the same per-pair arithmetic and tie rule)."""
    monkeypatch.setattr(tnn, "STREAM_TARGET", 0)
    rng = np.random.default_rng(m)
    tgt = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    tv = np.zeros(m, bool)
    tv[:live] = rng.random(live) < 0.7
    src = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    sv = rng.random(n) < 0.9
    args = [torch.from_numpy(a).to(dev) for a in (src, sv, tgt, tv)]
    before = dict(cuda_build.LAUNCHES)
    d_k, i_k = nn_sweep(*args)
    assert cuda_build.LAUNCHES["nn_sweep_split"] == before["nn_sweep_split"] + 1
    assert cuda_build.LAUNCHES["nn_sweep"] == before["nn_sweep"]
    d_b, i_b = nearest_neighbors_cuda(*args)
    d_p, i_p = nearest_neighbors(*args)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_b) and torch.equal(i_k, i_b)
    fin = torch.isfinite(d_p)
    assert torch.equal(torch.isfinite(d_k), fin)
    torch.testing.assert_close(d_k[fin], d_p[fin], rtol=1e-5, atol=1e-12)


def test_split_kernel_forced_streaming_case(dev):
    """tests/test_nn_onchip.py's forced-streaming case against float64."""
    rng = np.random.default_rng(7)
    src = rng.uniform(-1, 1, (333, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (6100, 3)).astype(np.float32)
    sv = np.ones(333, bool)
    sv[5] = False
    tv = np.ones(6100, bool)
    tv[1000:1500] = False
    tv[-1] = False
    d2, idx = (x.cpu().numpy() for x in nearest_neighbors_stream_cuda(
        *(torch.from_numpy(a).to(dev) for a in (src, sv, tgt, tv))))
    full = ((src[:, None, :].astype(np.float64) - tgt[None].astype(np.float64)) ** 2).sum(-1)
    full[:, ~tv] = np.inf
    np.testing.assert_array_equal(idx[sv], full.argmin(1)[sv])
    np.testing.assert_allclose(d2[sv], full.min(1)[sv], rtol=1e-5, atol=1e-7)
    assert np.isinf(d2[~sv]).all()


def _sweep_on(args, splits, fn=nearest_neighbors_cuda):
    """``fn`` (B1's wrapper by default) with the device plan's splits
    capped at ``splits`` (exactly ``splits`` where the card's slots hold
    that many for each live source tile)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnn, "SPLIT_CAP", splits)
        return fn(*args)


@pytest.mark.parametrize("n", [1000, 5000])
def test_nn_sweep_plan_independence(dev, n):
    """One input under splits 1, 2, 5, 17 and the default plan (the cap
    leaves it as the slots make it) gives the same dist2 and idx bit for
    bit."""
    rng = np.random.default_rng(n)
    m = 20_000
    tgt = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    tv = rng.random(m) < 0.8
    tv[15_000:] = False
    src = (tgt[rng.integers(0, 15_000, n)] + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    sv = rng.random(n) < 0.9
    args = [torch.from_numpy(a).to(dev) for a in (src, sv, tgt, tv)]
    d_ref, i_ref = nearest_neighbors_cuda(*args)
    for splits in (1, 2, 5, 17, tnn.MAX_SPLITS):
        d, i = _sweep_on(args, splits)
        assert torch.equal(d, d_ref) and torch.equal(i, i_ref), splits
    d_p, _ = nearest_neighbors(*args)
    fin = torch.isfinite(d_p)
    assert torch.equal(torch.isfinite(d_ref), fin)
    torch.testing.assert_close(d_ref[fin], d_p[fin], rtol=1e-5, atol=1e-12)


# each nn_check case's (score, index) per source from nn_scores on the
# card before the plan moved to the device (the host plan, per-split
# scratch), recorded on an NVIDIA H100 80GB HBM3
HOST_PLAN_NN_CHECK = Path(__file__).resolve().parent / "nn_sweep_host_plan_nn_check.npz"


def _src_live(sv) -> int:
    rows = np.flatnonzero(sv)
    return int(rows[-1]) + 1 if rows.size else 0


def _vs_plain(args, d_k, i_k):
    """The kernel's (dist2, idx) against the plain sweep: the same inf
    pattern, dist2 within 1e-5, indices equal except at exact ties."""
    d_p, i_p = nearest_neighbors(*args)
    fin = torch.isfinite(d_p)
    assert torch.equal(torch.isfinite(d_k), fin)
    torch.testing.assert_close(d_k[fin], d_p[fin], rtol=1e-5, atol=1e-12)
    diff = (fin & (i_k != i_p)).cpu().numpy()
    if diff.any():
        src, tgt = args[0].cpu().numpy().astype(np.float64), args[2].cpu().numpy()
        i_k, i_p = i_k.cpu().numpy(), i_p.cpu().numpy()
        da = ((src[diff] - tgt[i_k[diff]]) ** 2).sum(-1)
        db = ((src[diff] - tgt[i_p[diff]]) ** 2).sum(-1)
        assert (np.abs(da - db) <= 1e-5 + 1e-4 * np.maximum(db, 1.0)).all()


@pytest.mark.parametrize("splits", [1, 2, 5, 17, tnn.MAX_SPLITS])
@pytest.mark.parametrize("case", [c[0] for c in adversarial_cases()])
def test_nn_kernel_matches_host_plan_kernel(dev, case, splits):
    """Every nn_check case on both routes under forced split counts:
    each source before the live bound scores and wins as under the host
    plan (recorded), bit for bit; the rows past it give (inf, 0) from
    nn_scores and inf from nn_sweep; nn_sweep agrees with the plain
    sweep."""
    _, s, sv, t, tv = next(c for c in adversarial_cases() if c[0] == case)
    args = [torch.from_numpy(a).to(dev) for a in (s, sv, t, tv)]
    live = _src_live(sv)
    with np.load(HOST_PLAN_NN_CHECK) as rec:
        want_score, want_idx = rec[f"{case}.score"], rec[f"{case}.idx"]
    for stream in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tnn, "STREAM_TARGET", 0 if stream else tnn.STREAM_TARGET)
            mp.setattr(tnn, "SPLIT_CAP", splits)
            score, idx = (x.cpu().numpy() for x in tnn.nn_scores(*args))
            d2, i2 = nn_sweep(*args)
        np.testing.assert_array_equal(score[:live], want_score[:live])
        np.testing.assert_array_equal(idx[:live], want_idx[:live])
        assert np.isposinf(score[live:]).all() and (idx[live:] == 0).all()
        assert torch.isinf(d2[live:]).all()
        _vs_plain(args, d2, i2)


def _voxel_prefix(dev):
    """A real voxel grid's output as the sources (its valid rows a
    prefix of the slots) and another frame's cloud as the target."""
    from rspc_tpu_torch.capture.synthetic import SyntheticSequence
    from rspc_tpu_torch.ops.deproject import Intrinsics
    from rspc_tpu_torch.ops.voxel import voxel_downsample
    from rspc_tpu_torch.registration.schemes import _as_unorganized

    seq = SyntheticSequence(n_frames=2, yaw_step=-0.08, intr=Intrinsics.simple(160, 120))
    a, b = (_as_unorganized(c) for c in seq.clouds(device=dev))
    down = voxel_downsample(a, 0.01, 160 * 120)
    return down.xyz, down.valid, b.xyz, b.valid


@pytest.mark.parametrize("pattern", ["voxel_prefix", "scattered", "none"])
def test_nn_kernel_source_validity_patterns(dev, pattern):
    """Prefix validity (a voxel grid's output), scattered validity and
    no valid source, on every split count and both routes: the same bits
    on every plan, the plain sweep's answer, and (inf, 0) past the live
    bound."""
    rng = np.random.default_rng(9)
    if pattern == "voxel_prefix":
        args = [x.contiguous() for x in _voxel_prefix(dev)]
        sv = args[1].cpu().numpy()
        assert 0 < _src_live(sv) < sv.size and sv[:_src_live(sv)].all()
    else:
        n, m = 7000, 30_000
        sv = rng.random(n) < 0.3 if pattern == "scattered" else np.zeros(n, bool)
        args = [torch.from_numpy(a).to(dev) for a in (
            rng.uniform(-1, 1, (n, 3)).astype(np.float32), sv,
            rng.uniform(-1, 1, (m, 3)).astype(np.float32), rng.random(m) < 0.7)]
    live = _src_live(sv)
    ref = tnn.nn_scores(*args)
    for stream in (False, True):
        for splits in (1, 3, tnn.MAX_SPLITS):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tnn, "STREAM_TARGET", 0 if stream else tnn.STREAM_TARGET)
                mp.setattr(tnn, "SPLIT_CAP", splits)
                score, idx = tnn.nn_scores(*args)
                d2, i2 = nn_sweep(*args)
            assert torch.equal(score, ref[0]) and torch.equal(idx, ref[1])
            assert torch.isposinf(score[live:]).all() and not idx[live:].any()
            assert torch.isinf(d2[live:]).all() and not i2[live:].any()
            _vs_plain(args, d2, i2)


def test_nn_sweep_exact_ties_across_shares(dev):
    """Duplicates of every source's nearest target sit in one run, across
    a run boundary and in different splits (17 splits of 4,096 targets:
    shares of 241, so 240 and 241 straddle the first share boundary);
    the lowest index wins on every plan and on both routes."""
    rng = np.random.default_rng(5)
    m = 4096
    tgt = rng.uniform(5, 6, (m, 3)).astype(np.float32)
    p = np.array([0.1, 0.2, 0.3], np.float32)
    dups = [240, 241, 255, 256, 700, 2000, 4095]
    tgt[dups] = p
    src = (p + rng.uniform(-0.01, 0.01, (700, 3))).astype(np.float32)
    sv = np.ones(700, bool)
    tv = np.ones(m, bool)
    args = [torch.from_numpy(a).to(dev) for a in (src, sv, tgt, tv)]
    assert tnn.share_bounds(m, 17)[1][0] == 241
    results = [_sweep_on(args, s) for s in (1, 2, 17, 64)]
    results += [nearest_neighbors_cuda(*args), nearest_neighbors_stream_cuda(*args)]
    for d, i in results:
        assert (i == dups[0]).all()
        assert torch.equal(d, results[0][0])


def test_icp_fitness_sweep_takes_the_routed_kernel(dev, monkeypatch):
    """Every ICP sweep, the fitness sweep after the loop too, goes
    through the capacity routing: B2 once the target streams."""
    from rspc_tpu_torch.cloud import Cloud
    from rspc_tpu_torch.config import ICPConfig
    from rspc_tpu_torch.registration.icp import icp_align

    monkeypatch.setattr(tnn, "STREAM_TARGET", 0)
    rng = np.random.default_rng(3)
    tgt = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    src = (tgt[:1500] + rng.normal(0, 0.002, (1500, 3))).astype(np.float32)
    cloud = lambda a: Cloud(torch.from_numpy(a).to(dev), torch.zeros(a.shape, device=dev),
                            torch.ones(len(a), dtype=torch.bool, device=dev))
    before = dict(cuda_build.LAUNCHES)
    res = icp_align(cloud(src), cloud(tgt), ICPConfig(compute_fitness=True))
    assert np.isfinite(float(res.fitness))
    assert (cuda_build.LAUNCHES["nn_sweep_split"] - before["nn_sweep_split"]
            == int(res.iterations) + 1)
    assert cuda_build.LAUNCHES["nn_sweep"] == before["nn_sweep"]


def _hysteresis_vs_plain(strong, weak):
    """The kernel through the dispatch (one launch counted) against the
    plain version frame by frame, bit for bit."""
    before = cuda_build.LAUNCHES["hysteresis"]
    got = _hysteresis(strong, weak)
    assert cuda_build.LAUNCHES["hysteresis"] == before + 1
    want = torch.stack([_hysteresis_plain(s, w) for s, w in zip(strong, weak)])
    assert torch.equal(got, want), int((got != want).sum())
    return got


@pytest.mark.parametrize("shape,p_weak", [((3, 64, 256), 0.3), ((2, 480, 640), 0.45),
                                          ((1, 37, 33), 0.6), ((4, 720, 1280), 0.45),
                                          ((2, 1080, 1920), 0.6), ((1, 2000, 2000), 0.45)])
def test_hysteresis_kernel_matches_plain(dev, shape, p_weak):
    """Random batches, up to frames no shared memory could hold whole."""
    g = torch.Generator().manual_seed(shape[1])
    weak = torch.rand(shape, generator=g) < p_weak
    strong = weak & (torch.rand(shape, generator=g) < 0.03)
    strong[:, 0, 0] = True
    _hysteresis_vs_plain(strong.to(dev), weak.to(dev))


@pytest.mark.parametrize("case", [c[0] for c in hysteresis_cases(480, 640)])
def test_hysteresis_kernel_adversarial_cases(dev, case):
    """Every ``hysteresis_check`` case at 480x640, against the plain
    version and the ``scipy.ndimage.label`` oracle."""
    _, strong, weak = next(c for c in hysteresis_cases(480, 640) if c[0] == case)
    got = _hysteresis_vs_plain(torch.from_numpy(strong).to(dev),
                               torch.from_numpy(weak).to(dev))
    np.testing.assert_array_equal(got.cpu().numpy(), hysteresis_truth(strong, weak))


def test_hysteresis_kernel_unaligned_masks(dev):
    """Masks whose pointers forbid 16-byte loads and stores take the
    kernel's narrow loads, with the same bits."""
    g = torch.Generator().manual_seed(3)
    shape = (3, 96, 160)
    base_w = torch.rand((shape[0] * 96 * 160 + 3,), generator=g) < 0.5
    base_s = base_w & (torch.rand(base_w.shape, generator=g) < 0.01)
    weak = base_w.to(dev)[1:-2].view(shape)
    strong = base_s.to(dev)[3:].view(shape)
    assert weak.data_ptr() % 16 and strong.data_ptr() % 16
    _hysteresis_vs_plain(strong, weak)


def test_hysteresis_kernel_repeats_its_bits(dev):
    """Labels differ from launch to launch; the output must not."""
    _, strong, weak = hysteresis_cases(480, 640)[2]  # percolation at p_weak 0.41
    strong = torch.from_numpy(np.repeat(strong, 8, axis=0)).to(dev)
    weak = torch.from_numpy(np.repeat(weak, 8, axis=0)).to(dev)
    first = hysteresis_cuda(strong, weak)
    assert all(torch.equal(first[i], first[0]) for i in range(8))
    for _ in range(20):
        assert torch.equal(hysteresis_cuda(strong, weak), first)


@pytest.mark.parametrize("hc", [(0.4, 1.1), (0.05, 0.1)])
def test_hysteresis_kernel_on_high_curvature_masks(dev, hc):
    """The masks the 5-class labeler hands B3 for HIGH_CURVATURE (Canny on
    the normal image of 10 center-cropped rendered frames), at the default
    thresholds (weak creases without a strong pixel: a unit normal's
    (nx, ny) never passes 1.1) and at thresholds that light the class,
    against the plain version."""
    from rspc_tpu_torch.capture.synthetic import SyntheticSequence
    from rspc_tpu_torch.ops.canny import canny_from_gradients_masks
    from rspc_tpu_torch.ops.deproject import Intrinsics
    from rspc_tpu_torch.ops.normals import estimate_normals

    seq = SyntheticSequence(n_frames=10, yaw_step=-0.08, intr=Intrinsics.simple(640, 480))
    est = [estimate_normals(c) for c in seq.clouds(device=dev, center_crop=True)]
    nrm = torch.stack([e[0] for e in est])
    strong, weak = canny_from_gradients_masks(
        nrm[..., 0], nrm[..., 1], *hc, valid=torch.stack([e[1] for e in est]))
    assert strong.shape == (10, 288, 384)
    assert bool(weak.any()) and bool(strong.any()) == (hc != (0.4, 1.1))
    _hysteresis_vs_plain(strong.contiguous(), weak.contiguous())
