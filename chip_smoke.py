#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. check the card (exit 1 without one) and print its name and power limit;
  2. build the CUDA kernels from ``rspc_tpu_torch/csrc`` (into
     ``rspc_tpu_torch/_build/``) and print the build seconds;
  3. kernel B1 (NN sweep) against its plain PyTorch version on the card:
     the 9 adversarial ``nn_check`` cases against float64 truth, and one
     main-path shape (5,120 sources against a 102,400-capacity target);
  4. kernel B3 (Canny hysteresis) against its plain version, bit for bit,
     on the masks of 10 rendered 640x480 frames and on random masks;
  5. kernel B2 (the NN sweep with the target split across blocks) against
     the plain sweep: the 9 ``nn_check`` cases, the forced-streaming case
     of tests/test_nn_onchip.py (333 x 6,100 with holes) against float64
     brute force, and the incremental chain's last-pair shape (16,384
     sources against a 3,072,000-capacity target, 2,764,800 live);
  6. the north-star workload: 10 synthetic 640x480 frames, yaw -0.08 rad
     per frame, rendered on the card, through
     ``NDTEdgeBasedRegistration(rads=-0.08, config=north_star_config())``:
     one warm-up and timed runs; the launch counts of one registration
     show that it went through B1 and B3 (and not B2); every pair must
     converge and max |T_est - T_gt| must stay below 1e-3;
  7. the incremental workload: ``IncrementalICP`` (the incremental
     benchmark's config: ``PipelineConfig()`` without the fitness sweep)
     on the same 10 full clouds, a 3,072,000-point target capacity that
     routes every sweep to B2: one warm-up and timed runs, a staged run
     (stage walls and host syncs), and one counted run that must launch
     B2 and no plain version on the card, with every pair converged; the
     same registration with B1 serving it must agree per pair within
     1e-4. Its error against ground truth is printed, not gated:
     guess-free ICP drifts on a rotating sequence by design.

Each kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its FP32 operations (4
FMA-class operations per valid source x valid target pair for the NN
sweeps) over 33.5 T FMA/s, the published peaks of an H100 SXM at 700 W.

The last two lines of standard output are one JSON object per kernel
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 10
YAW_STEP = -0.08
WIDTH, HEIGHT = 640, 480
TIMED_RUNS = 3
MAX_ERR = 1e-3
# main-path NN shape: fine-ICP source (10,240-slot voxel cloud strided by 2)
# against the chain's edge target (voxel_cap x frames); the live prefix is
# half the capacity, the mean fill over the chain's nine pairs
NN_SRC, NN_TGT_CAP, NN_TGT_LIVE = 5120, 102_400, 51_200
NN_TOL = 1e-5  # |dist2| agreement at main-path shapes (f32 re-score of one winner)
# the incremental chain's last pair: the voxel source (VoxelConfig
# max_points) against 10 full frames' capacity, 9 of them live
INC_SRC, INC_TGT_CAP, INC_TGT_LIVE = 16_384, 10 * WIDTH * HEIGHT, 9 * WIDTH * HEIGHT
INC_PAIR_TOL = 1e-4  # per-pair transforms, B2-routed vs B1-routed run
# published H100 SXM peaks (700 W): HBM bytes/s and FP32 FMA/s (67 TFLOP/s)
HBM_BYTES_PER_S = 3.35e12
FP32_FMA_PER_S = 33.5e12
NN_OPS_PER_PAIR = 4  # 3 for s.t, 1 for |t|^2 + pen - 2 s.t


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, warm)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.element_size() * t.numel() for t in tensors)


def bound(nbytes_moved: int, ops: float) -> tuple[float, str]:
    """(least milliseconds, what bounds them) for a function that moves
    ``nbytes_moved`` bytes and does ``ops`` FP32 FMA-class operations."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S
    t_ops = ops / FP32_FMA_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nn_bound(src, sv, tgt, tv) -> dict:
    """Bound of one NN sweep on these inputs: every valid source against
    every valid target; it reads xyz and masks once and writes dist2 and
    idx once."""
    pairs = int(sv.sum()) * int(tv.sum())
    ms, by = bound(nbytes(src, sv, tgt, tv) + 8 * src.shape[0], NN_OPS_PER_PAIR * pairs)
    return {"bound_ms": ms, "bound_by": by}


def tie_ok(src, tgt, idx_a, idx_b, rtol=1e-4, atol=1e-5) -> bool:
    """Indices may differ only where both winners are at the same
    float64 distance (an exact tie up to f32 rounding)."""
    diff = idx_a != idx_b
    if not diff.any():
        return True
    s = src[diff].astype(np.float64)
    da = ((s - tgt[idx_a[diff]].astype(np.float64)) ** 2).sum(-1)
    db = ((s - tgt[idx_b[diff]].astype(np.float64)) ** 2).sum(-1)
    return bool((np.abs(da - db) <= atol + rtol * np.maximum(db, 1.0)).all())


def phase_nn(dev):
    import torch

    from rspc_tpu_torch.ops.nn import nearest_neighbors, nearest_neighbors_cuda
    from rspc_tpu_torch.ops.nn_check import adversarial_cases, run_nn_checks

    def on_card(s, sv, t, tv):
        d2, idx = nearest_neighbors_cuda(
            *(torch.from_numpy(np.array(a)).to(dev) for a in (s, sv, t, tv))
        )
        return d2.cpu().numpy(), idx.cpu().numpy()

    fails = run_nn_checks(on_card)
    if fails:
        raise AssertionError("B1 nn_check: " + "; ".join(fails))
    log(f"B1 nn_check: all {len(adversarial_cases())} adversarial cases pass")

    rng = np.random.default_rng(0)
    tgt = rng.uniform(-3.0, 3.0, (NN_TGT_CAP, 3)).astype(np.float32)
    tv = np.zeros(NN_TGT_CAP, bool)
    tv[:NN_TGT_LIVE] = rng.random(NN_TGT_LIVE) < 0.98
    src = (tgt[rng.integers(0, NN_TGT_LIVE, NN_SRC)]
           + rng.normal(0, 0.01, (NN_SRC, 3))).astype(np.float32)
    sv = rng.random(NN_SRC) < 0.95
    args = [torch.from_numpy(a).to(dev) for a in (src, sv, tgt, tv)]
    d_k, i_k = nearest_neighbors_cuda(*args)
    d_p, i_p = nearest_neighbors(*args, chunk=4096)
    d_k, i_k, d_p, i_p = (x.cpu().numpy() for x in (d_k, i_k, d_p, i_p))
    fin = np.isfinite(d_p)
    if not (np.isfinite(d_k) == fin).all():
        raise AssertionError("B1: inf pattern differs from the plain sweep")
    err = float(np.abs(d_k[fin] - d_p[fin]).max())
    if err > NN_TOL or not tie_ok(src, tgt, i_k[fin], i_p[fin]):
        raise AssertionError(f"B1 main shape: max |dist2| diff {err:.3e}")
    ms = cuda_ms(lambda: nearest_neighbors_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: nearest_neighbors(*args, chunk=4096), 5)
    lib_ms = cuda_ms(lambda: torch.cdist(args[0], args[2]).min(dim=1), 5)
    bnd = nn_bound(*args)
    log(f"B1 main shape {NN_SRC} x {NN_TGT_CAP} (live {NN_TGT_LIVE}): "
        f"max |dist2 kernel - plain| {err:.3e}; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, torch.cdist+min {lib_ms:.3f} ms, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")

    # the anchor's flattened sweep: 9 frames x 3,414 strided points vs 10,240
    a_src = torch.from_numpy(rng.uniform(-2, 2, (9 * 3414, 3)).astype(np.float32)).to(dev)
    a_sv = torch.ones(9 * 3414, dtype=torch.bool, device=dev)
    a_tgt = torch.from_numpy(rng.uniform(-2, 2, (10240, 3)).astype(np.float32)).to(dev)
    a_tv = torch.ones(10240, dtype=torch.bool, device=dev)
    a_ms = cuda_ms(lambda: nearest_neighbors_cuda(a_src, a_sv, a_tgt, a_tv), 20)
    a_plain = cuda_ms(lambda: nearest_neighbors(a_src, a_sv, a_tgt, a_tv, 2048), 5)
    a_lib = cuda_ms(lambda: torch.cdist(a_src, a_tgt).min(dim=1), 5)
    a_bnd = nn_bound(a_src, a_sv, a_tgt, a_tv)
    log(f"B1 anchor shape {9 * 3414} x 10240: kernel {a_ms:.3f} ms, plain {a_plain:.3f} ms, "
        f"torch.cdist+min {a_lib:.3f} ms, bound {a_bnd['bound_ms']:.4f} ms "
        f"({a_bnd['bound_by']})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": lib_ms}


def phase_nn_stream(dev):
    import torch

    from rspc_tpu_torch.ops.nn import (
        nearest_neighbors,
        nearest_neighbors_cuda,
        nearest_neighbors_stream_cuda,
        split_count,
    )
    from rspc_tpu_torch.ops.nn_check import adversarial_cases, run_nn_checks

    def on_card(s, sv, t, tv):
        d2, idx = nearest_neighbors_stream_cuda(
            *(torch.from_numpy(np.array(a)).to(dev) for a in (s, sv, t, tv))
        )
        return d2.cpu().numpy(), idx.cpu().numpy()

    fails = run_nn_checks(on_card)
    if fails:
        raise AssertionError("B2 nn_check: " + "; ".join(fails))
    log(f"B2 nn_check: all {len(adversarial_cases())} adversarial cases pass")

    # the forced-streaming case of tests/test_nn_onchip.py, vs float64
    rng = np.random.default_rng(7)
    src = rng.uniform(-1, 1, (333, 3)).astype(np.float32)
    tgt = rng.uniform(-1, 1, (6100, 3)).astype(np.float32)
    sv = np.ones(333, bool)
    sv[5] = False
    tv = np.ones(6100, bool)
    tv[1000:1500] = False
    tv[-1] = False
    d2, idx = on_card(src, sv, tgt, tv)
    full = ((src[:, None, :].astype(np.float64) - tgt[None].astype(np.float64)) ** 2).sum(-1)
    full[:, ~tv] = np.inf
    if not (idx[sv] == full.argmin(1)[sv]).all() or not np.isinf(d2[~sv]).all():
        raise AssertionError("B2 forced-streaming case: indices differ from float64")
    if not np.allclose(d2[sv], full.min(1)[sv], rtol=1e-5, atol=1e-7):
        raise AssertionError("B2 forced-streaming case: dist2 differs from float64")
    log("B2 forced-streaming case 333 x 6100: equal to float64 brute force")

    # the chain's last pair: 16,384 voxel sources against 9 of 10 frames
    rng = np.random.default_rng(1)
    tgt = rng.uniform(-3.0, 3.0, (INC_TGT_CAP, 3)).astype(np.float32)
    tv = np.zeros(INC_TGT_CAP, bool)
    tv[:INC_TGT_LIVE] = rng.random(INC_TGT_LIVE) < 0.9  # frames have holes
    src = (tgt[rng.integers(0, INC_TGT_LIVE, INC_SRC)]
           + rng.normal(0, 0.01, (INC_SRC, 3))).astype(np.float32)
    sv = rng.random(INC_SRC) < 0.95
    args = [torch.from_numpy(a).to(dev) for a in (src, sv, tgt, tv)]
    d_k, i_k = nearest_neighbors_stream_cuda(*args)
    d_p, i_p = nearest_neighbors(*args, chunk=4096)
    d_k, i_k, d_p, i_p = (x.cpu().numpy() for x in (d_k, i_k, d_p, i_p))
    fin = np.isfinite(d_p)
    if not (np.isfinite(d_k) == fin).all():
        raise AssertionError("B2: inf pattern differs from the plain sweep")
    err = float(np.abs(d_k[fin] - d_p[fin]).max())
    if err > NN_TOL or not tie_ok(src, tgt, i_k[fin], i_p[fin]):
        raise AssertionError(f"B2 last-pair shape: max |dist2| diff {err:.3e}")
    splits = split_count(INC_SRC)
    ms = cuda_ms(lambda: nearest_neighbors_stream_cuda(*args), 10)
    plain_ms = cuda_ms(lambda: nearest_neighbors(*args, chunk=4096), 1)
    b1_ms = cuda_ms(lambda: nearest_neighbors_cuda(*args), 3)
    bnd = nn_bound(*args)
    log(f"B2 last-pair shape {INC_SRC} x {INC_TGT_CAP} (live {INC_TGT_LIVE}), "
        f"{splits} splits: max |dist2 kernel - plain| {err:.3e}; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, B1 {b1_ms:.3f} ms, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); "
        f"no library call (a {INC_SRC} x {INC_TGT_LIVE} distance matrix is "
        f"{INC_SRC * INC_TGT_LIVE * 4 / 1e9:.0f} GB)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None}


def phase_hysteresis(dev, clouds):
    import torch

    from rspc_tpu_torch.config import EdgeConfig
    from rspc_tpu_torch.ops.canny import _hysteresis_plain, hysteresis_cuda
    from rspc_tpu_torch.ops.edges import _frame_inputs

    cfg = EdgeConfig()
    masks = [_frame_inputs(c, cfg)[2:] for c in clouds]
    strong = torch.stack([m[0] for m in masks]).contiguous()
    weak = torch.stack([m[1] for m in masks]).contiguous()
    got = hysteresis_cuda(strong, weak)
    want = torch.stack([_hysteresis_plain(s, w) for s, w in zip(strong, weak)])
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"B3: {bad} pixels differ on the rendered frames")
    g = torch.Generator(device="cpu").manual_seed(7)
    rweak = (torch.rand((4, HEIGHT, WIDTH), generator=g) < 0.3).to(dev)
    rstrong = (rweak & (torch.rand((4, HEIGHT, WIDTH), generator=g) < 0.02).to(dev))
    got_r = hysteresis_cuda(rstrong.contiguous(), rweak.contiguous())
    want_r = torch.stack([_hysteresis_plain(s, w) for s, w in zip(rstrong, rweak)])
    bad_r = int((got_r != want_r).sum())
    if bad_r:
        raise AssertionError(f"B3: {bad_r} pixels differ on random masks")
    ms = cuda_ms(lambda: hysteresis_cuda(strong, weak), 20)
    plain_ms = cuda_ms(
        lambda: [_hysteresis_plain(s, w) for s, w in zip(strong, weak)], 3
    )
    # memory floor: both masks read once, the result written once (the
    # fixpoint's rounds are not counted)
    bnd_ms, bnd_by = bound(nbytes(strong, weak, got), 0)
    log(f"B3 {len(clouds)} x {HEIGHT}x{WIDTH}: bit-exact vs plain "
        f"({int(want.sum())} edge pixels; random masks too); kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bnd_ms:.4f} ms ({bnd_by}); "
        f"no library call computes hysteresis")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd_ms,
            "bound_by": bnd_by, "library_ms": None}


def device_profile(fn) -> str:
    """One run of ``fn`` under ``torch.profiler``: the union of the
    card's busy intervals, its share of the profiled wall, and the device
    time of the largest kernels. Information only, never a gate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        return "the profiler saw no device events"
    busy, end = 0.0, float("-inf")
    per_name = {}
    for e in sorted(dev_events, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        per_name[e.name] = per_name.get(e.name, 0.0) + (stop - start)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
    return (f"device busy {busy / 1e3:.3f} ms of a {wall * 1e3:.1f} ms profiled run "
            f"({100 * busy / 1e3 / (wall * 1e3):.1f}%), {len(dev_events)} device events; "
            "largest: " + ", ".join(f"{n[:40]} {t / 1e3:.3f} ms" for n, t in top))


def phase_slice(dev, seq, clouds):
    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.presets import north_star_config
    from rspc_tpu_torch.registration.schemes import NDTEdgeBasedRegistration

    config = north_star_config()

    def run():
        scheme = NDTEdgeBasedRegistration(rads=YAW_STEP, config=config)
        result = scheme.registration(clouds)
        torch.cuda.synchronize()
        return scheme, result

    t0 = time.perf_counter()
    run()
    log(f"slice warm-up: {time.perf_counter() - t0:.3f} s")
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    log("slice timed runs (s): " + ", ".join(f"{t:.4f}" for t in times))
    log("slice profile: " + device_profile(run))

    cuda_build.reset_counts()
    scheme, result = run()
    launches = dict(cuda_build.LAUNCHES)
    plain = dict(cuda_build.PLAIN_ON_CUDA)
    totals = scheme.total_transforms.cpu().numpy()
    errs = [np.abs(totals[i - 1] - seq.gt_transform(i)).max() for i in range(1, N_FRAMES)]
    converged = [bool(f.converged) for _, f in scheme.results]
    max_err = float(max(errs))
    log(f"slice min wall {min(times):.4f} s; all_converged {all(converged)}; "
        f"max |T_est - T_gt| {max_err:.3e}; global points {int(result.count())}")
    log(f"launches in one registration: {launches}; plain versions on CUDA "
        f"tensors: {plain}")
    if not all(converged):
        raise AssertionError(f"not all pairs converged: {converged}")
    if not max_err < MAX_ERR:
        raise AssertionError(f"max |T_est - T_gt| {max_err:.3e} >= {MAX_ERR}")
    if (launches["nn_sweep"] <= 0 or launches["hysteresis"] <= 0
            or launches["nn_sweep_split"] != 0 or any(plain.values())):
        raise AssertionError(f"kernels not on the path: {launches}, plain {plain}")
    if not np.isfinite(result.xyz.cpu().numpy()).all():
        raise AssertionError("non-finite global cloud")
    return launches


def incremental_stages(clouds, cfg):
    """The scan path of ``IncrementalICP`` step by step, each stage
    bracketed by ``torch.cuda.synchronize()``: (stage seconds, host syncs
    of the unbracketed steps, per-pair transforms)."""
    import warnings

    import torch

    from rspc_tpu_torch.cloud import Cloud
    from rspc_tpu_torch.ops.transform import apply_transform_cloud
    from rspc_tpu_torch.ops.voxel import voxel_downsample
    from rspc_tpu_torch.registration.bufferops import _as_unorganized, _block_append
    from rspc_tpu_torch.registration.icp import icp_align

    secs = {"downsample": 0.0, "icp": 0.0, "transform+append": 0.0}
    syncs = 0

    def stage(name, fn):
        nonlocal syncs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        secs[name] += time.perf_counter() - t0
        syncs += sum("synchroniz" in str(w.message) for w in caught)
        return out

    flat = [_as_unorganized(c) for c in clouds]
    frame_cap = flat[0].capacity
    target = _block_append(Cloud.empty(len(flat) * frame_cap, flat[0].device), flat[0], 0)
    downs = stage("downsample", lambda: [
        voxel_downsample(c, cfg.voxel.leaf_size, cfg.voxel.max_points) for c in flat[1:]])
    transforms = []
    for i, (down, cloud) in enumerate(zip(downs, flat[1:]), start=1):
        res = stage("icp", lambda: icp_align(down, target, cfg.icp))
        target = stage("transform+append", lambda: _block_append(
            target, apply_transform_cloud(res.transform, cloud), frame_cap * i,
            gate=res.converged))
        transforms.append(res.transform)
    return secs, syncs, torch.stack(transforms)


def phase_incremental(dev, seq, clouds):
    import dataclasses

    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.config import PipelineConfig
    from rspc_tpu_torch.ops import nn
    from rspc_tpu_torch.registration.schemes import IncrementalICP

    base = PipelineConfig()
    config = dataclasses.replace(
        base, icp=dataclasses.replace(base.icp, compute_fitness=False))
    cap = sum(c.height * c.width for c in clouds)
    if not nn.streams(cap):
        raise AssertionError(f"target capacity {cap} does not route to B2")

    def run():
        scheme = IncrementalICP(config)
        result = scheme.registration(clouds)
        torch.cuda.synchronize()
        return scheme, result

    t0 = time.perf_counter()
    run()
    log(f"incremental warm-up: {time.perf_counter() - t0:.3f} s")
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    log("incremental timed runs (s): " + ", ".join(f"{t:.4f}" for t in times))

    log("incremental profile: " + device_profile(run))
    secs, syncs, staged_t = incremental_stages(clouds, config)
    log("incremental stages (s, synchronize between): "
        + ", ".join(f"{k} {v:.4f}" for k, v in secs.items())
        + f"; host syncs in the staged run: {syncs}")

    cuda_build.reset_counts()
    scheme, result = run()
    launches = dict(cuda_build.LAUNCHES)
    plain = dict(cuda_build.PLAIN_ON_CUDA)
    transforms = torch.stack([r.transform for r in scheme.results])
    converged = [bool(r.converged) for r in scheme.results]
    log(f"incremental launches in one registration: {launches}; plain versions on "
        f"CUDA tensors: {plain}; states {[int(r.state) for r in scheme.results]}; "
        f"iterations {[int(r.iterations) for r in scheme.results]}")
    if launches["nn_sweep_split"] <= 0 or any(plain.values()):
        raise AssertionError(f"B2 not on the incremental path: {launches}, plain {plain}")
    if not all(converged):
        raise AssertionError(f"not all incremental pairs converged: {converged}")
    xyz = result.xyz.cpu().numpy()
    if xyz.shape != (cap, 3) or not np.isfinite(xyz).all():
        raise AssertionError(f"incremental result: shape {xyz.shape} or non-finite xyz")
    staged_diff = float((staged_t - transforms).abs().max())
    if staged_diff > INC_PAIR_TOL:
        raise AssertionError(f"staged run differs from the scheme by {staged_diff:.3e}")

    # the same registration with B1 serving every sweep
    saved = nn.STREAM_TARGET
    nn.STREAM_TARGET = 10 * cap
    try:
        cuda_build.reset_counts()
        b1_scheme, b1_result = run()
        b1_launches = dict(cuda_build.LAUNCHES)
    finally:
        nn.STREAM_TARGET = saved
    b1_t = torch.stack([r.transform for r in b1_scheme.results])
    pair_diff = float((b1_t - transforms).abs().max())
    b1_conv = [bool(r.converged) for r in b1_scheme.results]
    log(f"B1-routed run: launches {b1_launches}; max per-pair |T_B2 - T_B1| "
        f"{pair_diff:.3e}; valid {int(result.count())} vs {int(b1_result.count())}; "
        f"staged run vs scheme {staged_diff:.3e}")
    if b1_launches["nn_sweep"] <= 0 or b1_launches["nn_sweep_split"] != 0:
        raise AssertionError(f"the B1-routed run did not take B1: {b1_launches}")
    if pair_diff > INC_PAIR_TOL or b1_conv != converged:
        raise AssertionError(f"B2 and B1 runs disagree: {pair_diff:.3e}, "
                             f"{converged} vs {b1_conv}")
    if int(result.count()) != int(b1_result.count()):
        raise AssertionError("B2 and B1 runs keep different point counts")
    if not np.isfinite(b1_result.xyz.cpu().numpy()).all():
        raise AssertionError("non-finite B1-routed result")

    t_np = transforms.cpu().numpy()
    gt_err = max(np.abs(t_np[i - 1] - seq.gt_transform(i)).max() for i in range(1, N_FRAMES))
    log(f"incremental min wall {min(times):.4f} s; all_converged {all(converged)}; "
        f"points {int(result.count())} of {cap}; max |T_est - T_gt| {gt_err:.3e} "
        f"(not gated: guess-free ICP drifts on a rotating sequence)")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    log(card_line())
    dev = torch.device("cuda:0")

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.capture.synthetic import SyntheticSequence
    from rspc_tpu_torch.ops.deproject import Intrinsics

    t0 = time.perf_counter()
    cuda_build.build(verbose=True)
    cuda_build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")

    nn = phase_nn(dev)
    nn_stream = phase_nn_stream(dev)

    seq = SyntheticSequence(
        n_frames=N_FRAMES, yaw_step=YAW_STEP, intr=Intrinsics.simple(WIDTH, HEIGHT)
    )
    t0 = time.perf_counter()
    clouds = seq.clouds(device=dev)
    torch.cuda.synchronize()
    log(f"rendered {N_FRAMES} {WIDTH}x{HEIGHT} frames on the card in "
        f"{time.perf_counter() - t0:.3f} s")

    hyst = phase_hysteresis(dev, clouds)
    launches = phase_slice(dev, seq, clouds)
    inc_launches = phase_incremental(dev, seq, clouds)

    if "jax" in sys.modules or "rspc_tpu" in sys.modules:
        raise AssertionError("the port imported jax or rspc_tpu")
    kernels = [
        {"name": "nn_sweep", "route": "cuda",
         "source": "rspc_tpu_torch/csrc/nn_sweep.cu",
         "replaces": "rspc_tpu/ops/nn_pallas.py:48",
         "launches": launches["nn_sweep"], **nn},
        {"name": "nn_sweep_split", "route": "cuda",
         "source": "rspc_tpu_torch/csrc/nn_sweep_split.cu",
         "replaces": "rspc_tpu/ops/nn_pallas.py:112",
         "launches": inc_launches["nn_sweep_split"], **nn_stream},
        {"name": "hysteresis", "route": "cuda",
         "source": "rspc_tpu_torch/csrc/hysteresis.cu",
         "replaces": "rspc_tpu/ops/canny.py:103",
         "launches": launches["hysteresis"], **hyst},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
