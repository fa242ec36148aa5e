"""The port's tracer (``rspc_tpu_torch/utils/profiling.py``) on the CPU:
spans, waits and counters off and on, device counters, the profiler's
clock, the Chrome trace, the NN sweep's source-row counter, and the spans
and counters of one ``IncrementalICP`` registration on both of its paths.
One test, marked ``cuda``, holds the kernels' device-side source-row
counter on the card (it skips without one)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rspc_tpu_torch.capture.synthetic import SyntheticSequence
from rspc_tpu_torch.config import PipelineConfig
from rspc_tpu_torch.ops import nn as tnn
from rspc_tpu_torch.ops.deproject import Intrinsics
from rspc_tpu_torch.ops.voxel import voxel_downsample
from rspc_tpu_torch.registration.schemes import IncrementalICP, _as_unorganized
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


def test_device_counts_are_read_after_the_call():
    """A device counter (a CPU tensor stands in for the card's) is one
    per call and name, made zero at its first use; ``collect`` adds it
    into the call's ``counts`` and ``COUNTS`` once. Off, or outside any
    call, there is none."""
    assert profiling.device_count("rows", "cpu") is None
    profiling.enable()
    assert profiling.device_count("rows", "cpu") is None
    with profiling.span("root"):
        t = profiling.device_count("rows", "cpu")
        assert t.dtype == torch.int64 and t.tolist() == [0]
        with profiling.span("child"):
            assert profiling.device_count("rows", "cpu") is t
            t += 5
        profiling.count("host", 1)
    with profiling.span("second"):
        profiling.device_count("rows", "cpu").add_(2)
    profiling.disable()
    assert "rows" not in profiling.COUNTS  # nothing read inside the window
    out = profiling.collect()
    by = _by_name(out["spans"])
    assert by["root"]["attrs"]["counts"] == {"host": 1, "rows": 5}
    assert by["second"]["attrs"]["counts"] == {"rows": 2}
    assert out["counters"]["rows"] == 7
    again = profiling.collect()  # read once
    assert again["counters"]["rows"] == 7 and by["root"]["attrs"]["counts"]["rows"] == 5


def test_plain_route_counts_the_valid_rows_it_sweeps():
    """The plain NN sweep counts the valid source rows it sweeps, and
    traces the sweep with the rows it was handed."""
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    tgt = torch.from_numpy(rng.normal(size=(500, 3)).astype(np.float32))
    sv = torch.from_numpy(rng.random(300) < 0.6)
    sv[250:] = False
    tv = torch.ones(500, dtype=torch.bool)
    profiling.enable()
    with profiling.span("root"):
        tnn.nn_sweep(src, sv, tgt, tv)
        tnn.nn_scores(src, sv, tgt, tv)
    profiling.disable()
    out = profiling.collect()
    assert out["counters"]["nn.source_rows"] == 2 * int(sv.sum())
    assert _by_name(out["spans"])["root"]["attrs"]["counts"] == {
        "nn.source_rows": 2 * int(sv.sum())}
    sweeps = [s for s in out["spans"] if s["name"] == "nn.sweep"]
    assert [s["attrs"]["sources"] for s in sweeps] == [300, 300]


@pytest.mark.cuda
def test_kernel_routes_count_the_live_source_rows(monkeypatch):
    """On the card: both kernel routes count ``src_live`` (the highest
    valid source index + 1) into the call's ``nn.source_rows``; a traced
    call makes no sync and at most one device op (the counter's fill)
    beyond the same sweeps run untraced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(2)
    n, m, src_live = 5000, 40_000, 3210
    sv = np.zeros(n, bool)
    sv[:src_live] = rng.random(src_live) < 0.8
    sv[src_live - 1] = True
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.normal(size=(n, 3)).astype(np.float32), sv,
        rng.normal(size=(m, 3)).astype(np.float32), rng.random(m) < 0.9)]
    monkeypatch.setattr(tnn, "STREAM_TARGET", 30_000)  # B2's route for the second

    def sweeps():
        tnn.nearest_neighbors_cuda(*args[:2], args[2][:20_000], args[3][:20_000])
        tnn.nearest_neighbors_stream_cuda(*args)

    def device_ops(traced: bool) -> int:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if traced:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with profiling.call("root"):
                        sweeps()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                sweeps()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        return sum(e.device_type() == cuda and not e.is_user_annotation()
                   for e in prof.profiler.kineto_results.events())

    sweeps()  # warm: the kernels' build and the card's plan
    untraced = device_ops(False)
    traced = device_ops(True)
    assert untraced <= traced <= untraced + 1
    root = _by_name(profiling.collect()["spans"])["root"]
    assert root["attrs"]["counts"] == {"nn.source_rows": 2 * src_live}


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
    # the plain route counts the valid sources it sweeps: each pair's
    # voxel means, once an ICP iteration
    valid = [int(voxel_downsample(_as_unorganized(c), config.voxel.leaf_size,
                                  VOXEL_CAP).valid.sum()) for c in clouds[1:]]
    assert counters["nn.source_rows"] == sum(
        v * int(r.iterations) for v, r in zip(valid, scheme.results))
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
