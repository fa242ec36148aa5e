"""``chain_wait_pct``: 100 x the host's seconds inside the program's
``wait`` spans (blocked on the card at a wait site) over the seconds of
the calls that hold them (the root spans), in the traced window, both on
the host's clock. Nothing is read from a program without the tracer.
Layer: the frame chain."""

from bench_port import program


def read(ctx: dict):
    recorded = program.spans()
    if recorded is None:
        return None
    calls_s = program.seconds(program.roots(recorded))
    waits = [s for s in recorded if s["kind"] == "wait" and s["parent"] is not None]
    return 100.0 * program.seconds(waits) / calls_s if calls_s > 0 else None
