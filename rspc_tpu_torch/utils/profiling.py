"""The port's tracer: spans and counters on the program's path, and the
operator's profiler export.

The reference has no tracing, only ``[RS]``/``[PCL]`` progress lines
(SURVEY.md §5). Here:

  * ``span(name, **attrs)`` brackets a stage of the program. Off (the
    default) it tests one module-level flag and returns one shared null
    context: no clock is read, no tensor is touched, and nothing is
    allocated beyond Python's keyword dict of the call;
  * ``call(name, **attrs)`` is the span of one program call, the root of
    its stages. It records as ``span`` does, and also, off, while
    ``torch.profiler`` records: then it records for the length of the
    call, so a profiled run gets the program's spans without ``enable``;
  * ``wait(site, syncs=1)`` brackets a point where the host blocks on
    the device. It always adds ``syncs`` to ``COUNTS["sync.<site>"]``;
    recording, it is also a span of kind ``wait`` named ``wait.<site>``;
  * ``count(name, n)`` adds ``n`` to ``COUNTS[name]``;
  * ``device_count(name, device)``, inside a recording call, hands a
    kernel an int64 counter on the device to add a count that only the
    device knows (the NN sweep's live source rows): one per call and
    name, allocated at its first use in the call (one fill on the
    device). ``collect()`` reads it after the window into the call's
    ``counts`` and ``COUNTS``; elsewhere it is None and the kernel adds
    nothing;
  * ``enable()`` clears the spans and ``COUNTS`` and records until
    ``disable()``; ``collect()`` hands out what was recorded;
  * ``trace(logdir)`` records a ``torch.profiler`` trace (host and CUDA
    activity) with the program's spans, and writes both into one Chrome
    trace in ``logdir``.

A span records its name, kind, id, parent span id, call id (new at each
root span, inherited by its children), attributes, and its start and end
on the profiler's clock. Spans are stamped with ``time.perf_counter_ns()``
and mapped onto that clock by one ``(perf_counter_ns, time_ns)`` pair taken
when recording starts: ``torch.profiler``'s event times are Unix-epoch
nanoseconds, with the card's events converted to them, so a span and a
device interval compare directly. A root span also carries, as its
attribute ``counts``, what its call added to ``COUNTS``, device counters
included once ``collect()`` has read them. Nothing is written while the
program runs, and the tracer adds no sync: it reads the values the host
holds, and the device counters only in ``collect()``, after the window.
Its one device work is a recording call's fill of each device counter it
uses.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
from torch.autograd import profiler as _torch_profiler

from rspc_tpu_torch import cuda_build
from rspc_tpu_torch.utils.log import get_logger

_log = get_logger("profiling")

COUNTS: dict[str, int] = {}
_NULL = contextlib.nullcontext()
_ON = False  # recording
_SPANS: list[dict] = []
_OPEN: list["_Span"] = []
# the device counters of ended calls not yet read: (the root span's
# record, name, tensor)
_PENDING: list[tuple[dict, str, torch.Tensor]] = []
_IDS = [0, 0]  # the last span id and call id given
_OFFSET = 0  # profiler-clock ns less perf_counter ns
# the Chrome trace's thread of the spans: an id no thread of the process has
_SPAN_TID = 2**31 - 1


def _start_clock() -> None:
    global _OFFSET
    _OFFSET = time.time_ns() - time.perf_counter_ns()


class _Span:
    """A recording span: ``follow`` turns recording on for its length."""

    __slots__ = ("name", "kind", "attrs", "follow", "id", "parent", "call", "counts",
                 "device", "t0")

    def __init__(self, name: str, kind: str, attrs: dict, follow: bool = False):
        self.name, self.kind, self.attrs, self.follow = name, kind, attrs, follow

    def __enter__(self):
        global _ON
        if self.follow:
            _start_clock()
            _ON = True
        parent = _OPEN[-1] if _OPEN else None
        _IDS[0] += 1
        self.id = _IDS[0]
        if parent is None:
            _IDS[1] += 1
            self.parent, self.call, self.counts = None, _IDS[1], dict(COUNTS)
            self.device = {}
        else:
            self.parent, self.call, self.counts = parent.id, parent.call, None
        _OPEN.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _ON
        t1 = time.perf_counter_ns()
        _OPEN.pop()
        attrs = self.attrs
        if self.counts is not None:
            before = self.counts
            attrs = {**attrs, "counts": {k: v - before.get(k, 0) for k, v in COUNTS.items()
                                         if v != before.get(k, 0)}}
        record = {"name": self.name, "kind": self.kind, "id": self.id,
                  "parent": self.parent, "call": self.call, "attrs": attrs,
                  "start_ns": self.t0 + _OFFSET, "end_ns": t1 + _OFFSET}
        _SPANS.append(record)
        if self.counts is not None:
            _PENDING.extend((record, name, t) for (name, _), t in self.device.items())
        if self.follow:
            _ON = False
        return False


def span(name: str, **attrs):
    """A stage of the program (see the module docstring)."""
    if not _ON:
        return _NULL
    return _Span(name, "span", attrs)


def call(name: str, **attrs):
    """One call of a program entry point: a span that also records, for
    its length, while ``torch.profiler`` records."""
    if _ON:
        return _Span(name, "span", attrs)
    if getattr(_torch_profiler, "_is_profiler_enabled", False):
        return _Span(name, "span", attrs, follow=True)
    return _NULL


def wait(site: str, syncs: int = 1):
    """A point where the host blocks on the device, ``syncs`` times (an
    op that syncs more than once): counted always, a ``wait`` span while
    recording."""
    key = "sync." + site
    COUNTS[key] = COUNTS.get(key, 0) + syncs
    if not _ON:
        return _NULL
    return _Span("wait." + site, "wait", {})


def count(name: str, n: int) -> None:
    """Adds ``n`` (a host-held number) to ``COUNTS[name]``."""
    COUNTS[name] = COUNTS.get(name, 0) + n


def device_count(name: str, device) -> torch.Tensor | None:
    """Inside a recording call (root span), the call's int64 ``[1]``
    counter on ``device`` that a kernel adds ``name``'s count to, made
    zero at its first use in the call; else None."""
    if not (_ON and _OPEN):
        return None
    key = (name, torch.device(device))
    t = _OPEN[0].device.get(key)
    if t is None:
        t = _OPEN[0].device[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return t


def _read_device_counts() -> None:
    """Adds the device counters of the calls that ended to the calls'
    ``counts`` and to ``COUNTS`` (one read from the device each)."""
    for record, name, t in _PENDING:
        v = int(t.item())
        COUNTS[name] = COUNTS.get(name, 0) + v
        counts = record["attrs"]["counts"]
        counts[name] = counts.get(name, 0) + v
    _PENDING.clear()


def enable() -> None:
    """Clears the spans and ``COUNTS`` and records until :func:`disable`."""
    global _ON
    _SPANS.clear()
    COUNTS.clear()
    _PENDING.clear()
    _start_clock()
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def collect() -> dict:
    """``{"spans": [...], "counters": {...}}``: the spans recorded since the
    last :func:`enable` (or, never enabled, by profiled calls), in the
    order they ended, and ``COUNTS`` with a snapshot of
    ``cuda_build.LAUNCHES`` and ``PLAIN_ON_CUDA`` (``launches.<kernel>``,
    ``plain_on_cuda.<kernel>``). Reads the device counters first (see
    :func:`device_count`): call it after the window, not inside a call."""
    _read_device_counts()
    counters = dict(COUNTS)
    counters.update({f"launches.{k}": v for k, v in cuda_build.LAUNCHES.items()})
    counters.update({f"plain_on_cuda.{k}": v for k, v in cuda_build.PLAIN_ON_CUDA.items()})
    return {"spans": list(_SPANS), "counters": counters}


def _chrome_events(spans: list[dict], base_ns: int) -> list[dict]:
    """The spans as Chrome trace events on a thread of their own, times in
    microseconds after ``base_ns`` (the trace's ``baseTimeNanoseconds``)."""
    pid, tid = os.getpid(), _SPAN_TID
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": "rspc_tpu_torch spans"}}]
    for s in spans:
        out.append({"ph": "X", "cat": f"rspc_{s['kind']}", "name": s["name"], "pid": pid,
                    "tid": tid, "ts": (s["start_ns"] - base_ns) / 1e3,
                    "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                    "args": {"id": s["id"], "parent": s["parent"], "call": s["call"],
                             **s["attrs"]}})
    return out


@contextlib.contextmanager
def trace(logdir: str = "rspc_trace"):
    """``torch.profiler`` over the block, host and CUDA activity (CUDA
    only where a card is present), with the tracer enabled; writes
    ``logdir/trace.json`` holding the profiler's events and the program's
    spans on one clock, which Perfetto or chrome://tracing opens. Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    _log.info("profiler trace -> %s", logdir)
    enable()
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        disable()
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += _chrome_events(collect()["spans"], int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(doc, f)
