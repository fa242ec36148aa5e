"""The port's tracer (``rspc_tpu_torch/utils/profiling.py``) on the CPU:
spans, waits and counters off and on, the profiler's clock, the Chrome
trace, and the spans and counters of one ``IncrementalICP`` registration
on both of its paths."""

import dataclasses
import json

import pytest
import torch

from rspc_tpu_torch.capture.synthetic import SyntheticSequence
from rspc_tpu_torch.config import PipelineConfig
from rspc_tpu_torch.ops.deproject import Intrinsics
from rspc_tpu_torch.registration.schemes import IncrementalICP
from rspc_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts with nothing recorded and leaves the tracer off."""
    profiling.enable()
    profiling.disable()
    yield
    profiling.disable()


def _by_name(spans):
    return {s["name"]: s for s in spans}


def test_spans_nest_with_parent_and_call_ids():
    profiling.enable()
    with profiling.span("a", k=1):
        with profiling.span("b"):
            pass
        with profiling.span("c"):
            pass
    with profiling.span("d"):
        pass
    spans = profiling.collect()["spans"]
    assert [s["name"] for s in spans] == ["b", "c", "a", "d"]  # in the order they end
    a, b, c, d = (_by_name(spans)[k] for k in "abcd")
    assert a["parent"] is None and d["parent"] is None
    assert b["parent"] == a["id"] and c["parent"] == a["id"]
    assert a["call"] == b["call"] == c["call"] != d["call"]
    assert len({s["id"] for s in spans}) == 4
    assert a["attrs"]["k"] == 1 and a["attrs"]["counts"] == {} and "counts" not in b["attrs"]
    assert a["start_ns"] <= b["start_ns"] <= b["end_ns"] <= c["start_ns"] <= a["end_ns"]
    assert all(s["kind"] == "span" for s in spans)


def test_off_records_nothing_and_returns_one_null_context():
    assert profiling.span("x") is profiling.span("y", k=2)
    with profiling.span("x"), profiling.call("root"):
        profiling.count("n", 3)
    out = profiling.collect()
    assert out["spans"] == [] and out["counters"]["n"] == 3


def test_wait_counts_off_and_on():
    with profiling.wait("site"):
        pass
    assert profiling.COUNTS["sync.site"] == 1 and profiling.collect()["spans"] == []
    profiling.enable()
    assert "sync.site" not in profiling.COUNTS  # enable() resets the counters
    with profiling.span("root"):
        with profiling.wait("site"):
            pass
        with profiling.wait("site"):
            pass
    profiling.disable()
    spans = profiling.collect()["spans"]
    waits = [s for s in spans if s["kind"] == "wait"]
    assert [s["name"] for s in waits] == ["wait.site"] * 2
    root = _by_name(spans)["root"]
    assert all(s["parent"] == root["id"] for s in waits)
    assert root["attrs"]["counts"] == {"sync.site": 2}
    assert profiling.COUNTS["sync.site"] == 2


def test_enable_resets_spans_and_counters():
    profiling.enable()
    with profiling.span("a"):
        profiling.count("k", 2)
    profiling.enable()
    assert profiling.collect()["spans"] == [] and "k" not in profiling.collect()["counters"]
    counters = profiling.collect()["counters"]
    assert {"launches.nn_sweep", "plain_on_cuda.nn_sweep"} <= set(counters)


def test_span_encloses_the_profiled_op_on_one_clock():
    """A span around ``a @ a`` encloses the profiler's ``aten::mm`` event:
    the spans' clock is the profiler's."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(64, 64)
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm"):
            a @ a
    profiling.disable()
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    s = _by_name(profiling.collect()["spans"])["mm"]
    assert len(mm) == 1
    start, end = mm[0].start_ns(), mm[0].start_ns() + mm[0].duration_ns()
    # a millisecond of slack for the clocks' granularity and conversion
    assert s["start_ns"] - 1_000_000 <= start <= end <= s["end_ns"] + 1_000_000
    assert end - start <= s["end_ns"] - s["start_ns"] + 1_000_000


def test_call_records_while_the_profiler_records():
    from torch.profiler import ProfilerActivity, profile

    with profiling.call("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.call("root", frames=2):
            with profiling.span("child"):
                with profiling.wait("w"):
                    pass
        with profiling.span("no root"):  # spans outside a call stay off
            pass
    spans = profiling.collect()["spans"]
    assert [s["name"] for s in spans] == ["wait.w", "child", "root"]
    assert _by_name(spans)["root"]["attrs"] == {"frames": 2, "counts": {"sync.w": 1}}
    with profiling.span("after"):
        pass
    assert len(profiling.collect()["spans"]) == 3


def test_trace_writes_the_program_spans(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("stage", k=1):
            with profiling.wait("site"):
                torch.ones(8).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat", "").startswith("rspc_")}
    assert set(ours) == {"stage", "wait.site"}
    assert ours["stage"]["args"]["k"] == 1 and ours["wait.site"]["cat"] == "rspc_wait"
    ops = [e for e in events if e.get("name") == "aten::sum"]
    assert ops and ours["stage"]["ts"] - 1e3 <= ops[0]["ts"] <= (
        ours["stage"]["ts"] + ours["stage"]["dur"] + 1e3)


W, H, N, VOXEL_CAP = 80, 60, 3, 1024


@pytest.fixture(scope="module")
def clouds():
    seq = SyntheticSequence(n_frames=N, yaw_step=-0.08, intr=Intrinsics.simple(W, H))
    return seq.clouds(device="cpu")


@pytest.mark.parametrize("use_scan", [True, False])
def test_incremental_spans_and_counters(clouds, use_scan):
    base = PipelineConfig()
    config = dataclasses.replace(
        base, use_scan=use_scan, icp=dataclasses.replace(base.icp, compute_fitness=False),
        voxel=dataclasses.replace(base.voxel, max_points=VOXEL_CAP))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        profiling.enable()
        scheme = IncrementalICP(config)
        scheme.registration(clouds)
        profiling.disable()
    finally:
        torch.set_num_threads(threads)
    out = profiling.collect()
    spans, counters = out["spans"], out["counters"]
    names = [s["name"] for s in spans]
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["incremental.registration"]
    assert roots[0]["attrs"]["frames"] == N and len({s["call"] for s in spans}) == 1
    assert names.count("voxel.downsample") == N - 1 and names.count("icp.align") == N - 1
    iterations = sum(int(r.iterations) for r in scheme.results)
    assert counters["sync.icp_stop"] == names.count("wait.icp_stop") == iterations
    # the fit's SVD: one wait of two syncs an iteration
    assert counters["sync.fit_svd"] == 2 * names.count("wait.fit_svd") == 2 * iterations
    assert names.count("icp.iter") == names.count("icp.fit") == iterations
    assert counters["nn.source_rows"] == iterations * VOXEL_CAP
    sweeps = [s for s in spans if s["name"] == "nn.sweep"]
    assert len(sweeps) == iterations
    assert all(s["attrs"]["route"] == "plain" and s["attrs"]["sources"] == VOXEL_CAP
               for s in sweeps)
    merges = sum(bool(r.converged) for r in scheme.results)
    if use_scan:
        assert "sync.merge" not in counters and names.count("map.append") == N
    else:
        assert counters["sync.merge"] == N - 1 and names.count("map.append") == 1 + merges
    assert roots[0]["attrs"]["counts"] == {k: v for k, v in counters.items()
                                           if k.startswith(("sync.", "nn."))}
    by_id = {s["id"]: s for s in spans}
    for s in spans:  # every span lies inside its parent
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
