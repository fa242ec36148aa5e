"""The port's NN sweep (the plain version of kernels B1 and B2) against
the JAX package's XLA sweep and its Pallas kernels in interpret mode
(B2, the HBM-streaming kernel, forced at test size by lowering
``MAX_VMEM_TARGET``), on the 9 adversarial ``nn_check`` cases against
float64 truth, and the port's capacity routing against the JAX wrapper's.

Tolerances: dist2 rtol 1e-5 (both re-score the winner exactly; only the
f32 argmin scores' rounding differs), indices equal except at exact
distance ties (``nn_check``'s contract: both winners at the same float64
distance within 1e-5 + 1e-4 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rspc_tpu.ops.nn_check as j_check
from rspc_tpu.ops.nn import nearest_neighbors as j_nn
from rspc_tpu.ops.nn_pallas import nearest_neighbors_pallas as j_nn_pallas
from rspc_tpu_torch import cuda_build
from rspc_tpu_torch.ops import nn_check as t_check
from rspc_tpu_torch.ops import nn as tnn
from rspc_tpu_torch.ops.nn import (
    nearest_neighbors,
    nearest_neighbors_cuda,
    nearest_neighbors_stream_cuda,
    nn_sweep,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores, where torch's spinning
    intra-op threads slow every worker down by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port(s, sv, t, tv, chunk=2048):
    d2, idx = nearest_neighbors(*_t(s, sv, t, tv), chunk=chunk)
    return d2.numpy(), idx.numpy()


def _assert_same(src, tgt, d_a, i_a, d_b, i_b):
    fin = np.isfinite(d_b)
    np.testing.assert_array_equal(np.isfinite(d_a), fin)
    np.testing.assert_allclose(d_a[fin], d_b[fin], rtol=1e-5, atol=1e-12)
    diff = fin & (i_a != i_b)
    if diff.any():
        s = src[diff].astype(np.float64)
        da = ((s - tgt[i_a[diff]].astype(np.float64)) ** 2).sum(-1)
        db = ((s - tgt[i_b[diff]].astype(np.float64)) ** 2).sum(-1)
        assert (np.abs(da - db) <= 1e-5 + 1e-4 * np.maximum(db, 1.0)).all()


def test_adversarial_cases_are_a_copy():
    want, got = j_check.adversarial_cases(), t_check.adversarial_cases()
    assert [c[0] for c in got] == [c[0] for c in want]
    for a, b in zip(got, want):
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("chunk", [1024, 2048])
def test_plain_sweep_passes_nn_check(chunk):
    fails = t_check.run_nn_checks(lambda s, sv, t, tv: _port(s, sv, t, tv, chunk))
    assert not fails, fails


@pytest.mark.parametrize("case", [c[0] for c in j_check.adversarial_cases()])
def test_plain_sweep_matches_jax_sweep(case):
    name, s, sv, t, tv = next(c for c in t_check.adversarial_cases() if c[0] == case)
    d_w, i_w = (np.asarray(x) for x in j_nn(*(jnp.asarray(a) for a in (s, sv, t, tv))))
    d_g, i_g = _port(s, sv, t, tv)
    _assert_same(s, t, d_g, i_g, d_w, i_w)


def test_plain_sweep_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    n, m = 300, 2500
    tgt = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    tv = rng.random(m) < 0.6
    tv[2200:] = False  # a dead tail: the kernel's live bound
    src = (tgt[rng.integers(0, 2200, n)] + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
    sv = rng.random(n) < 0.9
    d_w, i_w = (np.asarray(x) for x in j_nn_pallas(
        *(jnp.asarray(a) for a in (src, sv, tgt, tv)), interpret=True))
    d_g, i_g = _port(src, sv, tgt, tv)
    _assert_same(src, tgt, d_g, i_g, d_w, i_w)


def test_plain_sweep_matches_pallas_streaming_interpret(monkeypatch):
    """The forced-streaming case of tests/test_nn_onchip.py: the JAX
    package's B2 route (``_nn_kernel_hbm`` in interpret mode) against the
    port's CPU route, and both against float64 brute force."""
    import rspc_tpu.ops.nn_pallas as nnp

    monkeypatch.setattr(nnp, "MAX_VMEM_TARGET", 2000)
    rng = np.random.default_rng(7)
    src = rng.uniform(-1, 1, (333, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (6100, 3)).astype(np.float32)
    sv = np.ones(333, bool)
    sv[5] = False
    tv = np.ones(6100, bool)
    tv[1000:1500] = False
    tv[-1] = False
    d_w, i_w = (np.asarray(x) for x in nnp.nearest_neighbors_pallas(
        *(jnp.asarray(a) for a in (src, sv, tgt, tv)), interpret=True))
    d_g, i_g = (x.numpy() for x in nn_sweep(*_t(src, sv, tgt, tv)))
    _assert_same(src, tgt, d_g, i_g, d_w, i_w)
    np.testing.assert_allclose(d_g[sv], d_w[sv], rtol=1e-5, atol=1e-7)
    full = ((src[:, None, :].astype(np.float64) - tgt[None].astype(np.float64)) ** 2).sum(-1)
    full[:, ~tv] = np.inf
    np.testing.assert_array_equal(i_g[sv], full.argmin(1)[sv])
    assert np.isinf(d_g[~sv]).all()


@pytest.mark.parametrize("m", [102_400, 1_843_200, 2_500_000, 2_500_001, 3_072_000])
def test_routing_matches_jax(m):
    import rspc_tpu.ops.nn_pallas as nnp

    assert tnn.STREAM_TARGET == nnp.MAX_VMEM_TARGET
    assert tnn.TGT_CHUNK == nnp.TGT_CHUNK
    assert tnn.streams(m) == ((m + (-m) % nnp.TGT_CHUNK) > nnp.MAX_VMEM_TARGET)
    # the north-star target stays on B1; the 10-frame incremental one streams
    assert tnn.streams(m) == (m >= 2_500_000)


@pytest.mark.parametrize("n,src_live", [
    *((n, None) for n in (1, 255, 256, 257, 4096, 5120, 16_384, 30_726)),
    # the incremental cells' 307,200 voxel slots, live prefixes of none,
    # one, and a frame's 140,000-216,000 occupied voxels, and all
    *((307_200, k) for k in (0, 1, 140_000, 165_000, 216_000, 307_200)),
])
@pytest.mark.parametrize("sms,resident", [(132, 8), (132, 3), (114, 7), (132, 6), (1, 1)])
def test_plan_covers_every_source_once(n, src_live, sms, resident):
    """The NN sweep's plan over the live source prefix (mirroring the
    kernel's, made on the device): every live source in exactly one
    tile, the split count within its cap, one block per (tile, split)
    item in one wave of the resident slots that leaves fewer than
    ``tiles`` of them idle (one split, in waves, where the tiles
    outnumber the slots), inside a launch of ``max(slots, tiles(n))``
    blocks whose others exit; the kernel's block-to-item map visits
    every item once. A live prefix of all ``n`` rows gives the plan the
    host made from ``n`` alone."""
    p = tnn.plan(n, sms, resident, src_live)
    live = n if src_live is None else src_live
    slots = sms * resident
    tiles = [range(t * tnn.SRC_TILE, min(live, (t + 1) * tnn.SRC_TILE)) for t in range(p.tiles)]
    assert sorted(i for r in tiles for i in r) == list(range(live))
    assert all(len(r) > 0 for r in tiles)
    assert 1 <= p.splits <= tnn.MAX_SPLITS
    assert p.blocks == max(slots, -(-n // tnn.SRC_TILE))
    items = p.tiles * p.splits
    assert items <= p.blocks
    if p.tiles <= slots:
        assert items <= slots
        if p.tiles and p.splits < tnn.MAX_SPLITS:
            assert items > slots - p.tiles
    else:
        assert p.splits == 1
    # the kernel's map: block b < items takes tile b % tiles and split
    # b // tiles; the blocks from items on exit
    got = [(b % p.tiles, b // p.tiles) for b in range(items)]
    assert len(set(got)) == items
    assert set(got) == {(t, s) for t in range(p.tiles) for s in range(p.splits)}
    if live == n:
        tiles_n = -(-n // tnn.SRC_TILE)
        assert (p.tiles, p.splits) == (tiles_n, max(1, min(tnn.MAX_SPLITS, slots // tiles_n)))
        assert p == tnn.plan(n, sms, resident)


@pytest.mark.parametrize("live", [1, 307_200, 2_764_800, 3_072_000])
@pytest.mark.parametrize("splits", [1, 2, 17, 66, 211, 1024])
def test_shares_cover_live_prefix_once(live, splits):
    """The kernel's target shares (mirrored by ``share_bounds``): one per
    split, contiguous, ascending with the split, covering ``[0, live)``
    exactly once and even to within one share."""
    b = tnn.share_bounds(live, splits)
    assert len(b) == splits and b[0][0] == 0 and b[-1][1] == live
    assert all(lo <= hi for lo, hi in b)
    assert all(b[k][1] == b[k + 1][0] for k in range(splits - 1))
    assert sum(hi - lo for lo, hi in b) == live
    assert max(hi - lo for lo, hi in b) == -(-live // splits)


def _precedes(a, b):
    """The rule that combines the splits' (score, index) partials: the
    smaller score, then the lower index (-0.0 equals +0.0)."""
    return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])


@pytest.mark.parametrize("a,b", [
    ((-3.5, 9), (-1.0, 2)),  # negative scores
    ((-1e30, 5), (1e30, 1)),
    ((-1e-45, 5), (0.0, 1)),  # the least subnormals around zero
    ((1e-45, 1), (0.0, 9)),
    ((-0.0, 7), (0.0, 3)),  # -0.0 against +0.0: equal, the lower index wins
    ((0.0, 2), (-0.0, 8)),
    ((-0.0, 4), (0.0, 4)),
    ((1.5, 4), (1.5, 11)),  # equal scores: the lower index
    ((0.1, 2**31 - 1), (0.1, 0)),
    ((float("inf"), 0), (1e30, 123)),  # +inf carries index 0
    ((float("inf"), 0), (float("inf"), 0)),
    ((3.4e38, 2**31 - 1), (float("inf"), 0)),
])
def test_packed_key_orders_as_the_combining_rule(a, b):
    """The kernel's packed (score, index) key (``pack_key``, mirrored):
    two keys order as the partials do under the combining rule, so the
    smaller key decodes to the partial the rule keeps; every key
    round-trips (-0.0 as +0.0) and lies below the fill sentinel, which
    decodes to (+inf, 0)."""
    a, b = ((float(np.float32(v)), k) for v, k in (a, b))
    ka, kb = tnn.pack_key(*a), tnn.pack_key(*b)
    assert (ka < kb) == _precedes(a, b) and (kb < ka) == _precedes(b, a)
    want = b if _precedes(b, a) else a
    assert tnn.unpack_key(min(ka, kb)) == (want[0] + 0.0, want[1])
    for (v, k), key in ((a, ka), (b, kb)):
        back = tnn.unpack_key(key)
        assert back == (v, k) and np.signbit(back[0]) == (v < 0)
        assert key < tnn.KEY_SENTINEL
    assert tnn.unpack_key(tnn.KEY_SENTINEL) == (float("inf"), 0)
    # any written key, +inf with index 0 too, wins over the sentinel
    assert tnn.pack_key(float("inf"), 0) < tnn.KEY_SENTINEL


def test_packed_keys_sort_as_pairs():
    """Random f32 scores of both signs (with repeats, so that indices
    break ties) sort by key as (score, index) pairs do."""
    rng = np.random.default_rng(3)
    scores = np.concatenate([rng.normal(0, 10, 300), rng.normal(0, 1e-30, 100),
                             np.repeat(rng.normal(0, 1, 20), 5), [0.0, -0.0, np.inf]])
    scores = scores.astype(np.float32).tolist()
    idx = rng.integers(0, 2**31 - 1, len(scores)).tolist()
    pairs = list(zip(scores, idx))
    by_key = sorted(pairs, key=lambda p: tnn.pack_key(*p))
    assert [(v + 0.0, k) for v, k in by_key] == sorted((v + 0.0, k) for v, k in pairs)


@pytest.mark.parametrize("stream_target", [tnn.STREAM_TARGET, 10])
def test_dispatch_takes_plain_version_on_cpu(monkeypatch, stream_target):
    """CPU tensors take the plain sweep whichever kernel their capacity
    would route to on the card."""
    monkeypatch.setattr(tnn, "STREAM_TARGET", stream_target)
    rng = np.random.default_rng(2)
    s, t = rng.normal(size=(50, 3)).astype(np.float32), rng.normal(size=(80, 3)).astype(np.float32)
    sv, tv = np.ones(50, bool), np.ones(80, bool)
    cuda_build.reset_counts()
    d_a, i_a = nn_sweep(*_t(s, sv, t, tv))
    d_b, i_b = nearest_neighbors(*_t(s, sv, t, tv))
    assert torch.equal(i_a, i_b) and torch.equal(d_a, d_b)
    assert not any(cuda_build.LAUNCHES.values())
    assert not any(cuda_build.PLAIN_ON_CUDA.values())


@pytest.mark.parametrize("wrapper", [nearest_neighbors_cuda, nearest_neighbors_stream_cuda])
def test_kernel_wrapper_refuses_cpu_tensors(wrapper):
    x = torch.zeros((4, 3))
    v = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(x, v, x, v)


def test_measures_match_jax():
    from rspc_tpu.cloud import Cloud as JCloud
    from rspc_tpu.registration import measures as jm
    from rspc_tpu_torch.interop import cloud_from_numpy
    from rspc_tpu_torch.registration import measures as tm

    rng = np.random.default_rng(4)
    tgt = rng.uniform(-1, 1, (900, 3)).astype(np.float32)
    src = (tgt[:400] + rng.normal(0, 0.03, (400, 3))).astype(np.float32)
    sv, tv = rng.random(400) < 0.9, rng.random(900) < 0.8
    js = JCloud(jnp.asarray(src), jnp.zeros((400, 3)), jnp.asarray(sv))
    jt = JCloud(jnp.asarray(tgt), jnp.zeros((900, 3)), jnp.asarray(tv))
    ts = cloud_from_numpy({"xyz": src, "rgb": np.zeros((400, 3), np.float32), "valid": sv})
    tt = cloud_from_numpy({"xyz": tgt, "rgb": np.zeros((900, 3), np.float32), "valid": tv})
    np.testing.assert_allclose(float(tm._capped_mean_sq(ts, tt, 0.05)),
                               float(jm._capped_mean_sq(js, jt, 0.05)), rtol=1e-5)
    got, want = tm._inlier_stats(ts, tt, 0.04), jm._inlier_stats(js, jt, 0.04, False)
    assert float(got[0]) == float(want[0]) > 0
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-5)
