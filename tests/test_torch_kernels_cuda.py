"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: without a CUDA card every test skips (the
decision is taken inside the fixture, never at import). Run on the card
with ``python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py``
(``--noconftest``: tests/conftest.py imports jax, which the port's machine
need not have);
``chip_smoke.py`` runs the same checks at the main path's shapes."""

import numpy as np
import pytest
import torch

from rspc_tpu_torch import cuda_build
from rspc_tpu_torch.ops.canny import _hysteresis, _hysteresis_plain, hysteresis_cuda
from rspc_tpu_torch.ops import nn as tnn
from rspc_tpu_torch.ops.nn import (
    nearest_neighbors,
    nearest_neighbors_cuda,
    nearest_neighbors_stream_cuda,
    nn_sweep,
)
from rspc_tpu_torch.ops.nn_check import run_nn_checks

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


@pytest.mark.parametrize("shape,p_weak", [((3, 64, 256), 0.3), ((2, 480, 640), 0.45),
                                          ((1, 37, 33), 0.6)])
def test_hysteresis_kernel_matches_plain(dev, shape, p_weak):
    g = torch.Generator().manual_seed(shape[1])
    weak = torch.rand(shape, generator=g) < p_weak
    strong = weak & (torch.rand(shape, generator=g) < 0.03)
    strong[:, 0, 0] = True
    strong, weak = strong.to(dev), weak.to(dev)
    before = cuda_build.LAUNCHES["hysteresis"]
    got = _hysteresis(strong, weak)
    assert cuda_build.LAUNCHES["hysteresis"] == before + 1
    want = torch.stack([_hysteresis_plain(s, w) for s, w in zip(strong, weak)])
    assert torch.equal(got, want)


def test_hysteresis_kernel_refuses_oversized_frames(dev):
    big = torch.zeros((1, 2000, 2000), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        hysteresis_cuda(big, big)
