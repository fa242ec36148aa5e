"""``host_syncs_per_sweep``: the host syncs in the traced window
(``torch.cuda.set_sync_debug_mode("warn")``, ``trace.count_syncs``) over
the sweeps registered in it. Layer: the frame chain."""

def read(ctx: dict):
    if ctx["syncs"] is None or not ctx["sweeps"]:
        return None
    return ctx["syncs"] / ctx["sweeps"]
