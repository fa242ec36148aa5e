"""The readers of the program's spans and counters: a traced run on the
CPU at a small size reports them, with the numbers its calls' iterations
give; an untraced run records nothing; a program without the tracer
gives nothing to read and raises nothing."""

import time

import pytest

from _tiny import tiny

from bench_port import harness, program, spec
from rspc_tpu_torch.utils import profiling

NEW = ("program_syncs_per_sweep", "chain_wait_pct", "nn_source_use_pct")


def _run(traced):
    profiling.enable()  # nothing recorded before the run
    profiling.disable()
    cell = tiny("incr_icp.vga.seq6")
    run = harness.worker(cell, 2**31 + 29, 0.0, traced, time.perf_counter(), device="cpu")
    return cell, run, harness.result(cell, run, traced, harness.check(cell, run), "cpu")


def test_traced_run_reports_the_program_metrics():
    cell, run, out = _run(True)
    assert out["correct"] is True
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(metrics)
    calls = run["stats"]["calls"]
    its = sum(int(c["host"]["iterations"].sum()) for c in calls)
    # per ICP iteration: the stop test and the fit's SVD (two syncs)
    assert metrics["program_syncs_per_sweep"] == pytest.approx(3 * its / len(calls))
    assert 0.0 < metrics["chain_wait_pct"] < 100.0
    cap = cell["config"]["pipeline"]["voxel"]["max_points"]
    valid = sum(s for s, _ in harness.layer_context(run)["nn_work"])
    assert metrics["nn_source_use_pct"] == pytest.approx(100.0 * valid / (its * cap))
    assert len(program.roots(program.spans())) == len(calls)


def test_untraced_run_records_no_span():
    _, _, out = _run(False)
    assert program.spans() is None and out["correct"] is True


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "collect")
    ctx = {"sweeps": 4, "nn_work": [(10, 20)]}
    for name in NEW:
        assert spec.metric(name).read(ctx) is None
