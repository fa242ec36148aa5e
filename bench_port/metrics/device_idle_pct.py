"""``device_idle_pct``: 100 x the share of the traced window in which no
device event ran (the union of the kernel, copy and set intervals on
the profiler's clock). Layer: the device."""

def read(ctx: dict):
    if ctx["window_s"] <= 0 or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
