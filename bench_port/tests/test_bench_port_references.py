"""The plain reference on the CPU, at a small size: its grid search
finds what a search over every target finds, wherever that lies within
the radius, and it lands within the small cells' limits of the port."""

import pytest
import torch

from _tiny import tiny

from bench_port import spec, traffic
from bench_port.references.incremental_icp import nearest


def _pool(cell, only):
    cam = traffic.Camera(**cell["config"]["camera"])
    return traffic.make_pool(cell["mix"], cam, 2**31 + 41, torch.device("cpu"), only=only)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grid_nearest_is_the_nearest_within_the_radius(dtype):
    gen = torch.Generator().manual_seed(5)
    tgt = (torch.rand((3000, 3), generator=gen, dtype=torch.float64) * 0.2 - 0.1).to(dtype)
    tgt = torch.cat([tgt, tgt[:200]])  # equal rows: the lowest index wins
    src = (torch.rand((2000, 3), generator=gen, dtype=torch.float64) * 0.24 - 0.12).to(dtype)
    r = 0.01
    d2, idx = nearest(src, tgt, r)
    full = ((src[:, None, :] - tgt[None]) ** 2).sum(-1)
    want_d2, want_idx = full.min(dim=1)
    near = want_d2 <= r * r
    assert 100 < int(near.sum()) < 2000
    assert torch.equal(d2[near], want_d2[near]) and torch.equal(idx[near], want_idx[near])
    assert bool((d2[~near] > r * r).all())


def test_incremental_reference_within_the_limits():
    cell = tiny("incr_icp.vga.seq6")
    pool = _pool(cell, [0, 1])
    entry = spec.entry(cell["config"]).Entry(cell, pool, "cpu")
    ref = spec.reference(cell["config"])
    for sweeps, frames in entry.payloads:
        out = entry.run(frames)
        rec = {"sweeps": sweeps, "host": entry.host(out), "extra": entry.extra(out)}
        for j, answer in entry.answers(rec):
            got = ref.compare(answer, ref.register(pool[j], cell["config"], ref.REFERENCE))
            assert all(v <= cell["limits"][k] for k, v in got.items()), got
