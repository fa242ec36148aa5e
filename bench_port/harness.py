"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, the metrics, and the result line.

:func:`worker` runs the cell in this process:

  1. builds or loads the port's kernels (``rspc_tpu_torch/_build/``, in
     the checkout);
  2. renders the mix's pool of sweeps on the card from the seed
     (``traffic.py``) and hands them to the configuration's entry
     (``entries/<entry>.py``);
  3. warms up: ``warmup_calls`` calls, which run every shape the window
     runs; set-up ends here;
  4. calls the entry back to back, cycling over its payloads, until
     ``seconds`` have passed and every payload has run once; each call
     ends in ``torch.cuda.synchronize`` and its answer copied to the host;
  5. with ``--trace 1``, profiles a window of at most ``TRACE_SECONDS``
     (``torch.profiler``: the device's events and the CUDA runtime's
     calls) and counts its host syncs.

Then the memory peak is read, :func:`check` runs the reference on a
sample of sweeps drawn from the seed and compares every answer the
window gave for them, with ``limits/<cell>.json``, and :func:`result`
computes the metrics by their readers. :func:`main` prints the result as
the last line of standard output, each compared number beside its limit
as the last lines of standard error.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import numpy as np

from bench_port import spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "rspc_tpu")
# a traced run's window is at most this long: the profiler's events of a
# longer one take minutes to read
TRACE_SECONDS = 20.0
# what the traced window records: the device's events and the CUDA runtime
# calls (host ops as well would slow the host by half: PERF.md)
ACTIVITIES = ("CUDA",)


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def sample(pool: list[int], mix: dict, seed: int) -> list[int]:
    """The sweeps whose answers are checked: ``check_sweeps`` of the pool,
    drawn from the seed."""
    rng = np.random.default_rng([seed, 7])
    k = min(int(mix["check_sweeps"]), len(pool))
    return sorted(rng.choice(pool, size=k, replace=False).tolist())


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _activities(device) -> list:
    """The profiler's activities: ``ACTIVITIES`` on the card, the host's
    ops where the tests run the harness on the CPU."""
    from torch.profiler import ProfilerActivity

    return [getattr(ProfilerActivity, a)
            for a in (ACTIVITIES if device.type == "cuda" else ("CPU",))]


def window(entry, seconds: float, keep: set, traced: bool, device) -> dict:
    """The measured window (see the module docstring)."""
    import torch
    from torch.profiler import profile

    counter: dict = {}
    calls, lat = [], []
    n = len(entry.payloads)
    prof_ctx = (profile(activities=_activities(device)) if traced
                else contextlib.nullcontext())
    sync_ctx = (trace.count_syncs(counter) if traced and device.type == "cuda"
                else contextlib.nullcontext())
    with prof_ctx as prof, sync_ctx:
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < seconds or i < n:
            sweeps, payload = entry.payloads[i % n]
            t0 = time.perf_counter()
            out = entry.run(payload)
            _sync(device)
            rec = {"sweeps": sweeps, "host": entry.host(out)}
            lat.append(time.perf_counter() - t0)
            if i < n and keep.intersection(sweeps):
                rec["extra"] = entry.extra(out)
            del out
            calls.append(rec)
            i += 1
        window_s = time.perf_counter() - start
    stats = {"calls": calls, "latencies": lat, "window_s": window_s,
             "sweeps": len(calls) * entry.sweeps_per_call,
             "peak": torch.cuda.max_memory_allocated() if device.type == "cuda" else 0,
             "syncs": counter.get("syncs")}
    if traced:
        tr = trace.Trace(prof)
        stats["trace"] = tr.summary()
        log(f"traced window {(tr.window[1] - tr.window[0]) * 1e-9:.4f} s on the "
            f"profiler's clock, {window_s:.4f} s on the host's")
    return stats


def worker(cell: dict, seed: int, seconds: float, traced: bool, t0: float,
           device: str = "cuda:0") -> dict:
    """The run up to the window's close: ``{"stats", "entry", "pool",
    "keep"}``. ``device`` other than the card serves the tests of the
    harness on the CPU (no kernels, no memory readings)."""
    import torch

    from bench_port import traffic

    torch.set_num_threads(1)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        from rspc_tpu_torch import cuda_build

        torch.cuda.set_device(device)
        cuda_build.library()
    cfg, mix = cell["config"], cell["mix"]
    log(f"kernels ready at {time.perf_counter() - t0:.3f} s")
    pool = traffic.make_pool(mix, traffic.Camera(**cfg["camera"]), seed, device)
    entry = spec.entry(cfg).Entry(cell, pool, device)
    keep = set(sample(sorted(pool), mix, seed))
    _sync(device)
    log(f"inputs ready at {time.perf_counter() - t0:.3f} s")
    for i in range(int(mix["warmup_calls"])):
        entry.run(entry.payloads[i % len(entry.payloads)][1])
        _sync(device)
    if traced:  # the profiler's first start initialises its tracer: keep it out of the window
        from torch.profiler import profile

        with profile(activities=_activities(device)):
            torch.ones(1, device=device).add_(1)
            _sync(device)
    log(f"warmed up at {time.perf_counter() - t0:.3f} s")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    setup_s = time.perf_counter() - t0
    stats = window(entry, min(seconds, TRACE_SECONDS) if traced else seconds, keep, traced,
                   device)
    stats.update(base=base, setup_s=setup_s)
    return {"stats": stats, "entry": entry, "pool": pool, "keep": sorted(keep)}


def check(cell: dict, run: dict) -> dict:
    """Every compared number (the largest over the sampled sweeps' answers
    of every call), with its limit: ``{name: {"value", "limit"}}``."""
    cfg = cell["config"]
    ref = spec.reference(cfg)
    entry, pool, keep = run["entry"], run["pool"], set(run["keep"])
    got: dict[int, list] = {j: [] for j in keep}
    for rec in run["stats"]["calls"]:
        for j, answer in entry.answers(rec):
            if j in keep:
                got[j].append(answer)
    values: dict[str, float] = {}
    for j in sorted(keep):
        want = ref.register(pool[j], cfg, ref.REFERENCE)
        for answer in got[j]:
            for k, v in ref.compare(answer, want).items():
                values[k] = v if k not in values else max(values[k], v)
    limits = cell["limits"]
    return {k: {"value": v, "limit": limits.get(k)} for k, v in values.items()}


def layer_context(run: dict) -> dict:
    """What the per-layer readers read, over the traced window."""
    stats = run["stats"]
    work = []
    for rec in stats["calls"]:
        w = run["entry"].nn_sweeps(rec)
        if w is None:
            work = None
            break
        work += w
    return {**stats["trace"], "sweeps": stats["sweeps"], "syncs": stats["syncs"],
            "nn_work": work}


def e2e_context(cell: dict, run: dict) -> dict:
    stats = run["stats"]
    return {"setup_s": stats["setup_s"], "window_s": stats["window_s"],
            "frames": stats["sweeps"] * cell["mix"]["frames"],
            "latencies": stats["latencies"],
            "peak_bytes_above_inputs": stats["peak"] - stats["base"]}


def result(cell: dict, run: dict, traced: bool, checks: dict, device_kind: str) -> dict:
    stats = run["stats"]
    metrics_spec = cell["per_layer"] if traced else cell["end_to_end"]
    ctx = layer_context(run) if traced else e2e_context(cell, run)
    metrics = {}
    for m in metrics_spec:
        v = spec.metric(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": cell["workload"]["chips"],
              "memory_peak_bytes": int(stats["peak"])}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct and checks), "attempted": stats["sweeps"], "failed": 0,
           "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = ctx["busy_s"]
        device["window_s"] = ctx["window_s"]
        out["breakdown"] = {"device_ops": trace.top_ops(ctx["time_by_name"]),
                            "idle_gaps": ctx["idle_gaps"]}
    out["checks"] = checks
    return out


def main(args, t0: float) -> int:
    import torch

    log(f"torch imported at {time.perf_counter() - t0:.3f} s")
    cell = spec.cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell {args.workload} needs {chips} CUDA card(s); torch sees "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    run = worker(cell, args.seed, args.seconds, bool(args.trace), t0)
    checks = check(cell, run)
    out = result(cell, run, bool(args.trace), checks, torch.cuda.get_device_name(0))
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the port's benchmark may not")
        return 1
    print(json.dumps(out), flush=True)
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return 0
