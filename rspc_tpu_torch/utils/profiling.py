"""Tracing and profiling helpers (port of ``rspc_tpu/utils/profiling.py``).

The reference has no tracing, only ``[RS]``/``[PCL]`` progress lines
(SURVEY.md §5). Here:

  * ``device_sync`` waits for the card that holds the given tensors;
  * ``stage_timer`` accumulates named wall times, optionally closing
    each stage with ``device_sync``;
  * ``trace`` records a ``torch.profiler`` trace (host and CUDA
    activity) and writes it as a Chrome trace into ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from rspc_tpu_torch.utils.log import get_logger

_log = get_logger("profiling")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, name))


def device_sync(tree) -> None:
    """``torch.cuda.synchronize`` on every card that holds a tensor of
    ``tree`` (tensors, lists, tuples, dicts and dataclasses of them, such
    as clouds); CPU tensors need no barrier."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class stage_timer:
    """Accumulates named stage wall times (blocking on device completion).

    Usage::

        timers = stage_timer()
        with timers("edges", sync=edge):
            edge = extract_edge_features(cloud)
        print(timers.summary())

    ``sync`` is read when the stage ends, so pass a container the stage
    fills, or call ``device_sync`` inside the stage."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync: Optional[object] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                device_sync(sync)
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        rows = [
            f"{name}: {total*1000:.1f} ms ({self.counts[name]}x)"
            for name, total in sorted(
                self.times.items(), key=lambda kv: -kv[1]
            )
        ]
        return "\n".join(rows)


@contextlib.contextmanager
def trace(logdir: str = "rspc_trace"):
    """``torch.profiler`` over the block, host and CUDA activity (CUDA
    only where a card is present); writes ``logdir/trace.json``, which
    Perfetto or chrome://tracing opens. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _log.info("profiler trace -> %s", logdir)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
