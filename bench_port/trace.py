"""What a traced run reads: the profiler's device events and the host
syncs, reduced to plain numbers.

``count_syncs`` is ``chip_smoke.py::count_syncs``; ``Trace`` reads
the profiler's raw kineto events as ``chip_smoke.py::device_profile``
does (building the profiler's event tree takes minutes at these event
counts). All times are in seconds.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np

# the breakdown's longest idle gaps are named from this many of the longest
IDLE_GAPS_NAMED = 200
TOP = 10


@contextlib.contextmanager
def count_syncs(counter: dict):
    """Counts into ``counter["syncs"]`` the host syncs made inside the
    block: ``torch.cuda`` reports each synchronizing call as a warning
    under sync debug mode."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counter["syncs"] = counter.get("syncs", 0) + sum(
        "synchroniz" in str(w.message) for w in caught)


def union(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The union of intervals ``[starts[i], ends[i])`` as sorted,
    disjoint intervals."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.maximum.reduceat(e, idx)


class Trace:
    """A traced window: its device intervals and their names, its host
    events (the CUDA runtime calls, where the profiler records no host
    ops) and the window's bounds, from the first event the profiler saw to
    the end of the last, from a ``torch.profiler.profile`` that has
    stopped."""

    def __init__(self, prof):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        dev_s, dev_e, names, host_rows = [], [], [], []
        first, last = None, None
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            first = start if first is None else min(first, start)
            last = start + dur if last is None else max(last, start + dur)
            if e.device_type() == cuda:
                if e.is_user_annotation():  # a host span mirrored on the device's timeline
                    continue
                dev_s.append(start)
                dev_e.append(start + dur)
                names.append(e.name())
            elif dur > 0:
                host_rows.append((start, start + dur, e.name()))
        self.window = (first or 0, last or 0)
        self.dev_start = np.asarray(dev_s, dtype=np.int64)
        self.dev_end = np.asarray(dev_e, dtype=np.int64)
        by_name: dict[str, float] = {}
        for name, d in zip(names, (self.dev_end - self.dev_start).tolist()):
            by_name[name] = by_name.get(name, 0.0) + d * 1e-9
        self.time_by_name = by_name
        self.events = len(names)
        self.host = host_rows

    def summary(self) -> dict:
        """What the per-layer readers read of this trace (:func:`summary`)."""
        return summary(self.dev_start, self.dev_end, self.events, self.time_by_name,
                       self.host, self.window)


def summary(starts: np.ndarray, ends: np.ndarray, events: int, time_by_name: dict,
            host: list, window: tuple[int, int]) -> dict:
    """The device intervals ``[starts, ends)`` over the traced window
    ``(start_ns, end_ns)``: the seconds in which some event ran, the
    window's seconds, the events and the device time by name, and the
    longest idle gaps named by what the host was doing."""
    s, e = union(np.clip(starts, *window), np.clip(ends, *window))
    gaps_s = np.concatenate([[window[0]], e])
    gaps_e = np.concatenate([s, [window[1]]])
    keep = gaps_e > gaps_s
    return {"busy_s": float((e - s).sum()) * 1e-9,
            "window_s": (window[1] - window[0]) * 1e-9,
            "events": events, "time_by_name": time_by_name,
            "idle_gaps": name_gaps(gaps_s[keep], gaps_e[keep], host)}


def name_gaps(gaps_s: np.ndarray, gaps_e: np.ndarray, host: list) -> list:
    """The ``IDLE_GAPS_NAMED`` longest idle gaps, each named by the host op
    that overlaps it most (ties: the shortest, the innermost), their
    seconds summed by name, the ``TOP`` largest: ``[[name, s], ...]``.
    A gap that no host op overlaps is named ``host: between ops``."""
    if gaps_s.size == 0:
        return []
    order = np.argsort(gaps_s - gaps_e)[:IDLE_GAPS_NAMED]
    hs = np.asarray([h[0] for h in host], dtype=np.int64)
    he = np.asarray([h[1] for h in host], dtype=np.int64)
    out: dict[str, float] = {}
    for g in order:
        g0, g1 = gaps_s[g], gaps_e[g]
        name = "host: between ops"
        if hs.size:
            over = np.minimum(he, g1) - np.maximum(hs, g0)
            best = over.max()
            if best > 0:
                cand = np.flatnonzero(over == best)
                name = host[cand[np.argmin((he - hs)[cand])]][2]
        out[name] = out.get(name, 0.0) + float(g1 - g0) * 1e-9
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:TOP]]


def top_ops(time_by_name: dict) -> list:
    """The ``TOP`` device ops that took most time: ``[[name, s], ...]``."""
    return [[k, v] for k, v in sorted(time_by_name.items(), key=lambda kv: -kv[1])[:TOP]]
