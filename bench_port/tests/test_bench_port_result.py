"""A whole run on the CPU at a small size (the harness's look for a card
skipped): the result line's keys, and what the readers read."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest

from _tiny import ROOT, tiny

from bench_port import harness, roofline, trace

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(name, traced):
    cell = tiny(name)
    run = harness.worker(cell, 2**31 + 17, 0.0, traced, time.perf_counter(), device="cpu")
    checks = harness.check(cell, run)
    return cell, run, harness.result(cell, run, traced, checks, "cpu")


@pytest.mark.parametrize("traced", [False, True])
def test_result_keys(traced):
    cell, run, out = _run("incr_icp.vga.seq6", traced)
    want = KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(out) == want  # the checks come last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == len(run["stats"]["calls"]) >= cell["mix"]["pool"]
    assert set(out["checks"]) == set(cell["limits"])
    names = {m["name"] for m in (cell["per_layer"] if traced else cell["end_to_end"])}
    assert set(out["metrics"]) <= names
    if not traced:
        assert set(out["metrics"]) == names
    else:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in out["device"] and "window_s" in out["device"]
    json.dumps(out)


def test_without_the_port_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and bench_port/, a run
    fails and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                          "incr_icp.vga.seq6", "--seed", "3", "--seconds", "1", "--trace",
                          "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                          "incr_icp.vga.seq6", "--seed", "3", "--seconds", "1", "--trace",
                          "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and not out.stdout.strip()


def test_union_and_idle_gaps():
    s, e = trace.union(np.array([5, 0, 2, 20]), np.array([7, 3, 4, 25]))
    assert s.tolist() == [0, 5, 20] and e.tolist() == [4, 7, 25]
    m = trace.summary(np.array([5, 0, 2, 20]), np.array([7, 3, 4, 25]), 4, {"k": 1.0},
                      [(8, 19, "aten::item"), (9, 12, "aten::add")], (0, 30))
    assert m["busy_s"] == pytest.approx(11e-9)
    assert m["window_s"] == pytest.approx(30e-9)
    assert dict(m["idle_gaps"])["aten::item"] == pytest.approx(13e-9)


def test_nn_bound_of_a_small_sweep():
    secs, by = roofline.nn_bound_s(100, 2000)
    assert by == "operations"
    assert secs == pytest.approx(4 * 100 * 2000 / 33.5e12)
    secs, by = roofline.nn_bound_s(1, 1)
    assert by == "bytes" and secs == pytest.approx((21 + 13) / 3.35e12)


def test_incremental_nn_sweeps_counted_from_the_inputs():
    """Per pair: its iterations of (voxel means, map rows so far), the
    map growing by a frame's valid rows only where that pair converged."""
    import torch

    from bench_port import spec, traffic
    from bench_port.references.incremental_icp import voxel_means

    cell = tiny("incr_icp.vga.seq6")
    pool = traffic.make_pool(cell["mix"], traffic.Camera(**cell["config"]["camera"]), 5,
                             torch.device("cpu"), only=[0])
    entry = spec.entry(cell["config"]).Entry(cell, pool, "cpu")
    rec = {"sweeps": [0], "host": {"iterations": np.array([2, 1]),
                                   "converged": np.array([False, True])}}
    sw, vox = pool[0], cell["config"]["pipeline"]["voxel"]
    src = [voxel_means(sw.xyz[i], sw.valid[i], vox["leaf_size"], torch.float64).shape[0]
           for i in range(3)]
    rows = sw.valid.reshape(3, -1).sum(1).tolist()
    assert entry.nn_sweeps(rec) == [(src[1], rows[0])] * 2 + [(src[2], rows[0])]
