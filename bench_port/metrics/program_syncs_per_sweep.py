"""``program_syncs_per_sweep``: the host syncs the program counts at its
own wait sites (``profiling.wait``: the ICP stop tests, the rigid fit's
SVD, the loop path's merge tests), summed over the traced window's calls
(``program.counted(..., "sync.")``), over the sweeps registered in it.
``host_syncs_per_sweep`` less this is what the harness's copies add.
Nothing is read from a program without the tracer. Layer: the frame
chain."""

from bench_port import program


def read(ctx: dict):
    recorded = program.spans()
    if recorded is None or not ctx["sweeps"]:
        return None
    return program.counted(recorded, "sync.") / ctx["sweeps"]
