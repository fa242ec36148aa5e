"""``device_events_per_sweep``: the profiler's device events (kernels,
copies, sets) in the traced window over the sweeps registered in it.
Layer: torch ops and launches."""

def read(ctx: dict):
    return ctx["events"] / ctx["sweeps"] if ctx["sweeps"] and ctx["events"] else None
