"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have (the harness's look for a card
skipped, small sizes on the CPU): a step that returns its state
unchanged, and an answer altered where it is produced. No cell takes a
mean over its batch or exchanges rows between chips, so those faults
have no case here."""

import dataclasses
import time

import pytest

from _tiny import tiny

from bench_port import harness


def _moved(t):
    t = t.clone()
    t[..., 0, 3] += 1e-3
    return t


def unchanged_map(schemes, monkeypatch):
    """IncrementalICP appends no frame to its map."""
    monkeypatch.setattr(schemes, "_block_append", lambda dst, src, offset, gate=None: dst)


def altered_pair(schemes, monkeypatch):
    """IncrementalICP's ICP answers a transform moved by 1 mm."""
    icp_align = schemes.icp_align

    def moved(*a, **k):
        res = icp_align(*a, **k)
        return dataclasses.replace(res, transform=_moved(res.transform))

    monkeypatch.setattr(schemes, "icp_align", moved)


FAULTS = [("incr_icp.vga.seq6", unchanged_map, "map_valid_mismatch"),
          ("incr_icp.vga.seq6", altered_pair, "pair_gap")]


@pytest.mark.parametrize("name,fault,number", FAULTS, ids=[f[1].__name__ for f in FAULTS])
def test_fault_is_not_correct(name, fault, number, monkeypatch):
    from rspc_tpu_torch.registration import schemes

    fault(schemes, monkeypatch)
    cell = tiny(name)
    run = harness.worker(cell, 2**31 + 29, 0.0, False, time.perf_counter(), device="cpu")
    checks = harness.check(cell, run)
    res = harness.result(cell, run, False, checks, "cpu")
    assert res["correct"] is False
    c = checks[number]
    assert c["value"] > c["limit"], checks
