"""``sweep_p95_s``: the 95th percentile (linear interpolation) of every
call's time in the window, from handing the sweep to the entry until its
answer is on the host after ``torch.cuda.synchronize()``; host clock.
One call registers one sweep in the cells that report it."""

import numpy as np


def read(ctx: dict):
    lat = ctx["latencies"]
    return float(np.percentile(lat, 95)) if lat else None
