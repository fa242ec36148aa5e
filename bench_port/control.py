#!/usr/bin/env python3
"""The readings that a cell's limits for ``correct`` are set from, on the
card at the cell's own sizes:

    python3 bench_port/control.py --workload NAME --seeds N [N ...] [--program]

For each seed, the sweeps a run of that seed checks (``harness.sample``)
are registered by the reference in its own precision and by the control:
the reference in the precision below the configuration's (TF32 for its
float32 with TF32 off), put in the program's place. ``--program`` also
registers them through the entry, as the window does. Each seed's numbers (``reference.compare``, the largest
over its sweeps) print as one JSON line; the last line holds the largest
of each over the seeds. The benchmark's runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def readings(cell: dict, seed: int, program: bool, device: str = "cuda:0") -> dict:
    """One seed's numbers: ``{"control": {...}, "program": {...}}``."""
    import torch

    from bench_port import harness, spec, traffic

    cfg, mix = cell["config"], cell["mix"]
    ref = spec.reference(cfg)
    dev = torch.device(device)
    pool = traffic.make_pool(mix, traffic.Camera(**cfg["camera"]), seed, dev)
    entry = None
    if program:
        entry = spec.entry(cfg).Entry(cell, pool, dev)
    keep = harness.sample(sorted(pool), mix, seed)
    out: dict = {"seed": seed, "sweeps": keep, "control": {}, "program": {}}
    for j in keep:
        want = ref.register(pool[j], cfg, ref.REFERENCE)
        got = {"control": ref.register(pool[j], cfg, ref.CONTROL)}
        if entry is not None:
            payload = [p for s, p in entry.payloads if j in s][0]
            res = entry.run(payload)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            rec = {"sweeps": [s for s, p in entry.payloads if j in s][0],
                   "host": entry.host(res), "extra": entry.extra(res)}
            got["program"] = dict(entry.answers(rec))[j]
        for side, answer in got.items():
            for k, v in ref.compare(answer, want).items():
                out[side][k] = v if k not in out[side] else max(out[side][k], v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    args = p.parse_args(argv)
    import torch

    from bench_port import spec
    from rspc_tpu_torch import cuda_build

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    cuda_build.library()
    cell = spec.cell(args.workload)
    worst: dict = {"control": {}, "program": {}}
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cell, seed, args.program)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
        for side in ("control", "program"):
            for k, v in r[side].items():
                worst[side][k] = v if k not in worst[side] else max(worst[side][k], v)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "largest": worst,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
