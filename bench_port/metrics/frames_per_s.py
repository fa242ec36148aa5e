"""``frames_per_s``: every frame handed to the entry by the window's
calls over the window's seconds (the window ends with the call running
when ``--seconds`` have passed)."""

def read(ctx: dict):
    return ctx["frames"] / ctx["window_s"]
