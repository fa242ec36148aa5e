"""``setup_s``: seconds from the start of ``run.py`` to the first timed
call: imports, the kernels' build or load, the sweeps rendered on the
card, the entry's inputs, warm-up."""

def read(ctx: dict):
    return ctx["setup_s"]
