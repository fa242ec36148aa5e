"""The program's own spans over a traced window, for the per-layer
readers.

The port's tracer (``rspc_tpu_torch/utils/profiling.py``) records each
call of an entry point, with its stages, its host waits and the counters
the call added, while ``torch.profiler`` records. So after a traced run
it holds the calls of the traced window and nothing else: the harness's
other profiled stretch, the profiler's first start, runs no program call.
A program without the tracer, or one that recorded no call, gives None,
and every reader of this module then reads nothing."""

from __future__ import annotations


def spans() -> list | None:
    """Every span the program recorded, or None."""
    try:
        from rspc_tpu_torch.utils import profiling
    except ImportError:
        return None
    collect = getattr(profiling, "collect", None)
    if collect is None:
        return None
    out = collect()["spans"]
    return out if any(s["parent"] is None for s in out) else None


def roots(recorded: list) -> list:
    """The root spans: one a call of the entry."""
    return [s for s in recorded if s["parent"] is None]


def counted(recorded: list, prefix: str) -> int:
    """What the calls added to the program's counters whose names start
    with ``prefix`` (each root span's ``counts``)."""
    return sum(v for r in roots(recorded) for k, v in r["attrs"].get("counts", {}).items()
               if k.startswith(prefix))


def seconds(recorded: list) -> float:
    return sum(s["end_ns"] - s["start_ns"] for s in recorded) * 1e-9
