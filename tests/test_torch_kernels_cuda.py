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
from rspc_tpu_torch.ops.nn import nearest_neighbors, nearest_neighbors_cuda, nn_sweep
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
