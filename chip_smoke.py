#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. check the card (exit 1 without one) and print its name and power limit;
  2. build the CUDA kernels from ``rspc_tpu_torch/csrc`` (into
     ``rspc_tpu_torch/_build/``) and print the build seconds;
  3. the NN sweep on B1's route (``csrc/nn_sweep.cu``, ``ops/nn.py::plan``)
     against its plain PyTorch version on the card: the 9 adversarial
     ``nn_check`` cases against float64 truth, and the main-path shapes
     (5,120 sources against a 102,400-capacity target, also config 3's
     coarse ICP; the anchor's 30,726 x 10,240; the reference preset's
     16,384 x 163,840), each held against the plain sweep and printed with
     its launch plan, and the kernel's ``ptxas`` registers and spills;
  4. kernel B3 (Canny hysteresis, ``csrc/hysteresis.cu``) against its
     plain version, bit for bit, on the masks of 10 rendered 640x480
     frames, on random masks, on every ``ops/hysteresis_check.py`` case at
     480x640, on the masks of 10 rendered 1280x720 frames and on a
     10 x 480 x 640 percolation batch (p_weak 0.6), each timed;
  5. the same kernel and plan on B2's route against the plain
     sweep: the 9 ``nn_check`` cases, the forced-streaming case of
     tests/test_nn_onchip.py (333 x 6,100 with holes) against float64
     brute force, and the incremental chain's last-pair shape (16,384
     sources against a 3,072,000-capacity target, 2,764,800 live), with
     its plan;
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
     same registration on B1's route must agree per pair within 1e-4
     (the kernel gives both routes the same winners bit for bit, so the
     difference is expected to be exactly 0). Its error against ground
     truth is printed, not gated: guess-free ICP drifts on a rotating
     sequence by design;
  8. BASELINE config 2: the 10 frames center-cropped to 288x384 and
     labelled together with all five classes (``EdgeConfig()``): B3
     launched twice (the high-curvature and the RGB masks) and no plain
     version on the card; the high-curvature masks (and the same at
     thresholds that light the class) through B3 equal the plain version
     bit for bit; the depth classes equal the port's CPU run exactly and
     the whole labels differ from it in at most 0.1% of the valid pixels
     of any frame; the labeler's min wall of 3 runs and B3's time on the
     high-curvature masks;
  9. BASELINE config 3: ``ICPEdgeBasedRegistration(thetas=seq.thetas(),
     config=north_star_config())`` on the 10 full frames, the IMU filter
     on the card: one warm-up, timed runs, a profile and a counted run
     (host syncs too); every pair converged, max |T_est - T_gt| < 1e-3,
     B1's route and B3 launched, B2's route and the plain versions not;
     the thetas equal those of the capture loop (``get_clouds``) over a
     replay recording of the same frames and IMU stream (atol 1e-6);
 10. the reference's ``--all`` path: that recording through
     ``get_clouds`` with ``CaptureConfig()`` (BGR swizzle, 3/5 crop),
     then ``ICPEdgeBasedRegistration(thetas, config=PipelineConfig(),
     dataset_dir=...)``: finite totals; ``edge-{i}.pcd`` for every frame
     and ``edge_cloud.pcd`` written and read back equal to the clouds
     stored; the loop path (``use_scan=False``) with the same converged
     flags and totals within 2e-4 (its host syncs counted); the RGB-only
     labeller with identical totals; the converged count and the error
     against ground truth printed, not gated (the reference preset has
     no guard and a 1 cm fine cap); and ``NDTEdgeBasedRegistration(
     rads=-0.08, config=PipelineConfig())`` once on the same clouds;
 11. the command line, through ``rspc_tpu_torch.cli.main`` in a temporary
     directory on the CLI's synthetic source (10 x 640x480, yaw -0.15
     rad), each command from launch counts set to 0, rc 0 and no plain
     version on the card required, its wall printed and, from a profiled
     rerun, the card's busy time: ``--capture seq 10`` with the odometry
     (10 PCDs and 9 match PNGs, the same bytes as a run without the
     odometry, good matches and translation per pair printed; keypoints
     and descriptors of one frame equal bit for bit over two runs);
     ``--edges seq-0.pcd`` (the 5-class labeller: B3 twice);
     ``--registration seq -9 10`` (read back within 1e-4 m of the same
     scheme run through the API; B1 and B3); ``--view seq-0`` (the PNG
     against the CPU render, at most 0.1% of the pixels apart);
     ``--all 10 out`` (out.pcd and 11 edge PCDs, B3 twice and B1, totals
     within 1e-5 of the API run).

A kernel's time (``ms``) is the kernel's own (CUDA events around
launches on inputs the wrapper packed once; for the NN sweep both
passes); the NN entries also carry ``wrapper_ms``, the wrapper's time
with its packing and re-score. B3's time is that of whole calls (its
three passes) queued behind a sleep kernel (``device_ms``), so that it
is the card's time and not the host's rate of launching them.
Each kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its FP32 operations (4
FMA-class operations per valid source x valid target pair for the NN
sweeps) over 33.5 T FMA/s, the published peaks of an H100 SXM at 700 W.

Each path's run that counts launches starts from counts set to 0; the
kernels line sums them over the paths and an earlier line gives them per
path. The last two lines of standard output are one JSON object per kernel
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
# the reference preset's sweeps: every voxel edge point (no source cap,
# VoxelConfig max_points) against 10 frames' voxel capacity, half live
REF_SRC, REF_TGT_CAP, REF_TGT_LIVE = 16_384, 163_840, 81_920
CROP_H, CROP_W = 288, 384  # the 3/5 center crop of 480x640
EDGE_DIFF_FRAC = 1e-3  # labels vs the CPU run: share of a frame's valid pixels
PATHS_TOL = 2e-4  # fused vs loop totals (tests/test_pipeline.py)
DEPTH_TYPES = ("nan_boundary", "occluding", "occluded")
HC_LIT = (0.05, 0.1)  # high-curvature thresholds that light this scene's creases
# the incremental chain's last pair: the voxel source (VoxelConfig
# max_points) against 10 full frames' capacity, 9 of them live
INC_SRC, INC_TGT_CAP, INC_TGT_LIVE = 16_384, 10 * WIDTH * HEIGHT, 9 * WIDTH * HEIGHT
INC_PAIR_TOL = 1e-4  # per-pair transforms, B2-routed vs B1-routed run
# published H100 SXM peaks (700 W): HBM bytes/s and FP32 FMA/s (67 TFLOP/s)
HBM_BYTES_PER_S = 3.35e12
FP32_FMA_PER_S = 33.5e12
NN_OPS_PER_PAIR = 4  # 3 for s.t, 1 for |t|^2 + pen - 2 s.t
# kernel B3's passes, by the names of their kernels (csrc/hysteresis.cu)
B3_PASSES = ("hysteresis_local", "hysteresis_merge", "hysteresis_output")
# the CLI phase: the CLI's default synthetic source, --registration's
# degrees, and what each command is held to
CLI_FRAMES, CLI_DEG = 10, -9
CLI_REG_TOL = 1e-4  # m, the registration file against the API run
CLI_ALL_TOL = 1e-5  # m, --all's out.pcd against the API run
CLI_VIEW_TIE_FRAC = 1e-3  # --view PNG pixels that may differ from the CPU render


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


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card with the calls queued
    ahead: a sleep kernel holds the card while the host enqueues all
    ``reps`` calls, which then run back to back. The sleep grows until it
    outlasts the enqueueing, so the host's launch rate never shows."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    while True:
        e0, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < e0.elapsed_time(start):
            return start.elapsed_time(end) / reps
        cycles *= 4


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


def plan_line(p, dev) -> str:
    """The NN sweep's launch plan as one phrase."""
    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.ops.nn import SRC_TILE

    resident = cuda_build.nn_sweep_resident()
    slots = torch.cuda.get_device_properties(dev).multi_processor_count * resident
    return (f"plan: {p.tiles} tiles of {SRC_TILE} sources x {p.splits} splits = "
            f"{p.tiles * p.splits} blocks on {slots} resident slots ({resident} per SM)")


def nn_vs_plain(what, args, got, chunk):
    """Hold the wrapper's ``got`` (dist2, idx) against the plain sweep on
    ``args``: the same inf pattern, dist2 within ``NN_TOL``, and indices
    equal except at exact ties. Returns the max |dist2| difference."""
    from rspc_tpu_torch.ops.nn import nearest_neighbors

    d_p, i_p = nearest_neighbors(*args, chunk=chunk)
    d_k, i_k, d_p, i_p = (x.cpu().numpy() for x in (*got, d_p, i_p))
    fin = np.isfinite(d_p)
    if not (np.isfinite(d_k) == fin).all():
        raise AssertionError(f"{what}: inf pattern differs from the plain sweep")
    err = float(np.abs(d_k[fin] - d_p[fin]).max())
    src, tgt = args[0].cpu().numpy(), args[2].cpu().numpy()
    if err > NN_TOL or not tie_ok(src, tgt, i_k[fin], i_p[fin]):
        raise AssertionError(f"{what}: max |dist2| diff {err:.3e} or indices differ")
    return err


def nn_kernel_only(args, p):
    """The NN sweep's kernel alone (both passes, ``ops/nn.py::_launch``)
    on ``args`` packed once by the wrappers' ``_pack``, on plan ``p``: a
    closure for ``cuda_ms``. Bypasses the wrappers, so it counts no
    launch."""
    from rspc_tpu_torch.ops.nn import _launch, _pack

    packed = _pack(*args)
    return lambda: _launch(*packed, p)


def phase_nn(dev):
    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.ops.nn import card_plan, nearest_neighbors, nearest_neighbors_cuda
    from rspc_tpu_torch.ops.nn_check import adversarial_cases, run_nn_checks

    def on_card(s, sv, t, tv):
        d2, idx = nearest_neighbors_cuda(
            *(torch.from_numpy(np.array(a)).to(dev) for a in (s, sv, t, tv))
        )
        return d2.cpu().numpy(), idx.cpu().numpy()

    log("NN sweep " + cuda_build.ptxas_report("nn_sweep_pass1"))
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
    err = nn_vs_plain("B1 main shape", args, nearest_neighbors_cuda(*args), 4096)
    plan = card_plan(NN_SRC, dev)
    ms = cuda_ms(nn_kernel_only(args, plan), 50)
    wrap_ms = cuda_ms(lambda: nearest_neighbors_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: nearest_neighbors(*args, chunk=4096), 5)
    lib_ms = cuda_ms(lambda: torch.cdist(args[0], args[2]).min(dim=1), 5)
    bnd = nn_bound(*args)
    log(f"B1 main shape {NN_SRC} x {NN_TGT_CAP} (live {NN_TGT_LIVE}), "
        f"{plan_line(plan, dev)}: max |dist2 kernel - plain| {err:.3e}; kernel {ms:.4f} ms "
        f"(wrapper with packing and re-score {wrap_ms:.3f} ms), "
        f"plain {plain_ms:.3f} ms, torch.cdist+min {lib_ms:.3f} ms, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")

    # the anchor's flattened sweep: 9 frames x 3,414 strided points vs 10,240
    a_src = torch.from_numpy(rng.uniform(-2, 2, (9 * 3414, 3)).astype(np.float32)).to(dev)
    a_sv = torch.ones(9 * 3414, dtype=torch.bool, device=dev)
    a_tgt = torch.from_numpy(rng.uniform(-2, 2, (10240, 3)).astype(np.float32)).to(dev)
    a_tv = torch.ones(10240, dtype=torch.bool, device=dev)
    a_args = (a_src, a_sv, a_tgt, a_tv)
    a_err = nn_vs_plain("B1 anchor shape", a_args, nearest_neighbors_cuda(*a_args), 2048)
    a_plan = card_plan(9 * 3414, dev)
    a_ms = cuda_ms(nn_kernel_only(a_args, a_plan), 50)
    a_wrap = cuda_ms(lambda: nearest_neighbors_cuda(*a_args), 20)
    a_plain = cuda_ms(lambda: nearest_neighbors(a_src, a_sv, a_tgt, a_tv, 2048), 5)
    a_lib = cuda_ms(lambda: torch.cdist(a_src, a_tgt).min(dim=1), 5)
    a_bnd = nn_bound(a_src, a_sv, a_tgt, a_tv)
    log(f"B1 anchor shape {9 * 3414} x 10240, {plan_line(a_plan, dev)}: "
        f"max |dist2 kernel - plain| {a_err:.3e}; "
        f"kernel {a_ms:.4f} ms (wrapper {a_wrap:.3f} ms), plain {a_plain:.3f} ms, "
        f"torch.cdist+min {a_lib:.3f} ms, bound {a_bnd['bound_ms']:.4f} ms "
        f"({a_bnd['bound_by']})")

    # the reference preset's sweeps: 16,384 voxel edge points against the
    # 10-frame voxel target
    tgt = rng.uniform(-3.0, 3.0, (REF_TGT_CAP, 3)).astype(np.float32)
    tv = np.zeros(REF_TGT_CAP, bool)
    tv[:REF_TGT_LIVE] = rng.random(REF_TGT_LIVE) < 0.98
    src = (tgt[rng.integers(0, REF_TGT_LIVE, REF_SRC)]
           + rng.normal(0, 0.01, (REF_SRC, 3))).astype(np.float32)
    sv = rng.random(REF_SRC) < 0.95
    r_args = [torch.from_numpy(a).to(dev) for a in (src, sv, tgt, tv)]
    r_err = nn_vs_plain("B1 reference-preset shape", r_args,
                        nearest_neighbors_cuda(*r_args), 4096)
    r_plan = card_plan(REF_SRC, dev)
    r_ms = cuda_ms(nn_kernel_only(r_args, r_plan), 20)
    r_wrap = cuda_ms(lambda: nearest_neighbors_cuda(*r_args), 10)
    r_plain = cuda_ms(lambda: nearest_neighbors(*r_args, chunk=4096), 2)
    r_lib = cuda_ms(lambda: torch.cdist(r_args[0], r_args[2]).min(dim=1), 2)
    r_bnd = nn_bound(*r_args)
    log(f"B1 reference-preset shape {REF_SRC} x {REF_TGT_CAP} (live {REF_TGT_LIVE}), "
        f"{plan_line(r_plan, dev)}: max |dist2 kernel - plain| {r_err:.3e}; "
        f"kernel {r_ms:.4f} ms (wrapper {r_wrap:.3f} ms), plain {r_plain:.3f} ms, "
        f"torch.cdist+min {r_lib:.3f} ms, bound {r_bnd['bound_ms']:.4f} ms "
        f"({r_bnd['bound_by']})")
    return {"max_abs_err": max(err, a_err, r_err), "ms": ms, "wrapper_ms": wrap_ms,
            "plain_ms": plain_ms, **bnd, "library_ms": lib_ms,
            "ms_reference_shape": r_ms, "bound_ms_reference_shape": r_bnd["bound_ms"]}


def phase_nn_stream(dev):
    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.ops.nn import (
        card_plan,
        nearest_neighbors,
        nearest_neighbors_stream_cuda,
    )
    from rspc_tpu_torch.ops.nn_check import adversarial_cases, run_nn_checks

    def on_card(s, sv, t, tv):
        d2, idx = nearest_neighbors_stream_cuda(
            *(torch.from_numpy(np.array(a)).to(dev) for a in (s, sv, t, tv))
        )
        return d2.cpu().numpy(), idx.cpu().numpy()

    log("NN sweep " + cuda_build.ptxas_report("nn_sweep_pass1"))
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
    err = nn_vs_plain("B2 last-pair shape", args, nearest_neighbors_stream_cuda(*args), 4096)
    plan = card_plan(INC_SRC, dev)
    ms = cuda_ms(nn_kernel_only(args, plan), 10)
    wrap_ms = cuda_ms(lambda: nearest_neighbors_stream_cuda(*args), 10)
    plain_ms = cuda_ms(lambda: nearest_neighbors(*args, chunk=4096), 1)
    bnd = nn_bound(*args)
    log(f"B2 last-pair shape {INC_SRC} x {INC_TGT_CAP} (live {INC_TGT_LIVE}), "
        f"{plan_line(plan, dev)}: max |dist2 kernel - plain| {err:.3e}; kernel {ms:.3f} ms "
        f"(wrapper {wrap_ms:.3f} ms), plain {plain_ms:.3f} ms, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); "
        f"no library call (a {INC_SRC} x {INC_TGT_LIVE} distance matrix is "
        f"{INC_SRC * INC_TGT_LIVE * 4 / 1e9:.0f} GB)")
    return {"max_abs_err": err, "ms": ms, "wrapper_ms": wrap_ms, "plain_ms": plain_ms,
            **bnd, "library_ms": None}


def edge_masks(clouds):
    """(strong, weak) bool ``[B, H, W]`` of the RGB Canny of ``clouds``:
    what the north star hands kernel B3."""
    import torch

    from rspc_tpu_torch.config import EdgeConfig
    from rspc_tpu_torch.ops.edges import _frame_inputs

    masks = [_frame_inputs(c, EdgeConfig())[2:] for c in clouds]
    return (torch.stack([m[0] for m in masks]).contiguous(),
            torch.stack([m[1] for m in masks]).contiguous())


def percolation_batch(dev):
    """10 x 480 x 640 random masks above the 8-connected percolation
    threshold (p_weak 0.6): one component spans each frame."""
    import torch

    from rspc_tpu_torch.ops.hysteresis_check import random_masks

    s, w = random_masks(np.random.default_rng(11), (N_FRAMES, HEIGHT, WIDTH), 0.6, 0.002)
    return torch.from_numpy(s).to(dev), torch.from_numpy(w).to(dev)


def render(dev, width, height):
    from rspc_tpu_torch.capture.synthetic import SyntheticSequence
    from rspc_tpu_torch.ops.deproject import Intrinsics

    seq = SyntheticSequence(n_frames=N_FRAMES, yaw_step=YAW_STEP,
                            intr=Intrinsics.simple(width, height))
    return seq, seq.clouds(device=dev)


def phase_hysteresis(dev, clouds):
    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.ops.canny import PASSES, TILE, _hysteresis_plain, hysteresis_cuda, plan
    from rspc_tpu_torch.ops.hysteresis_check import hysteresis_cases

    for name in B3_PASSES:
        log("B3 " + cuda_build.ptxas_report(name))

    def vs_plain(what, strong, weak):
        got = hysteresis_cuda(strong, weak)
        want = torch.stack([_hysteresis_plain(s, w) for s, w in zip(strong, weak)])
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"B3: {bad} pixels differ on {what}")
        return int(want.sum())

    strong, weak = edge_masks(clouds)
    lit = vs_plain("the rendered frames", strong, weak)
    g = torch.Generator(device="cpu").manual_seed(7)
    rweak = (torch.rand((4, HEIGHT, WIDTH), generator=g) < 0.3).to(dev)
    rstrong = (rweak & (torch.rand((4, HEIGHT, WIDTH), generator=g) < 0.02).to(dev))
    vs_plain("random masks", rstrong.contiguous(), rweak.contiguous())
    cases = hysteresis_cases(HEIGHT, WIDTH)
    for name, s, w in cases:
        vs_plain(f"hysteresis_check case {name}",
                 torch.from_numpy(s).to(dev), torch.from_numpy(w).to(dev))
    _, hd = render(dev, 1280, 720)
    hd_strong, hd_weak = edge_masks(hd)
    del hd
    vs_plain("the rendered 1280x720 frames", hd_strong, hd_weak)
    p_strong, p_weak = percolation_batch(dev)
    vs_plain("the percolation batch", p_strong, p_weak)

    ms = device_ms(lambda: hysteresis_cuda(strong, weak), 50)
    hd_ms = device_ms(lambda: hysteresis_cuda(hd_strong, hd_weak), 50)
    perc_ms = device_ms(lambda: hysteresis_cuda(p_strong, p_weak), 50)
    plain_ms = cuda_ms(
        lambda: [_hysteresis_plain(s, w) for s, w in zip(strong, weak)], 3
    )
    # memory floor: both masks read once, the result written once (the
    # labels are the kernel's own traffic, not the function's)
    bnd_ms, bnd_by = bound(3 * strong.numel(), 0)
    p = plan(*strong.shape)
    log(f"B3 {len(clouds)} x {HEIGHT}x{WIDTH}, {PASSES} passes over {p.tiles} tiles of "
        f"{TILE}x{TILE}: bit-exact vs plain ({lit} edge pixels; random masks, "
        f"{len(cases)} hysteresis_check cases, 10 x 720x1280 and the percolation batch "
        f"too); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bnd_ms:.5f} ms "
        f"({bnd_by}); 10 x 720x1280 {hd_ms:.4f} ms; percolation batch {perc_ms:.4f} ms; "
        f"no library call computes hysteresis")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd_ms,
            "bound_by": bnd_by, "library_ms": None, "passes": PASSES,
            "tile": f"{TILE}x{TILE}", "ms_720x1280": hd_ms, "ms_percolation": perc_ms}


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
    sweep = [e for e in dev_events if "nn_sweep_pass" in e.name]
    sweep_ms = sum(e.time_range.end - e.time_range.start for e in sweep) / 1e3
    b3 = {}
    for e in dev_events:
        for name in B3_PASSES:
            if name in e.name:
                b3[name] = b3.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    b3_line = ", ".join(f"{n} {b3[n]:.4f} ms" for n in B3_PASSES if n in b3) or "none"
    return (f"device busy {busy / 1e3:.3f} ms of a {wall * 1e3:.1f} ms profiled run "
            f"({100 * busy / 1e3 / (wall * 1e3):.1f}%), {len(dev_events)} device events; "
            f"NN sweep (both passes) {sweep_ms:.3f} ms over {len(sweep)} kernels; "
            f"B3 passes: {b3_line}; "
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

    # the same registration with B1's route serving every sweep
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


def count_syncs(fn):
    """(fn's result, the host syncs it made): ``torch.cuda`` reports each
    synchronizing call as a warning under sync debug mode."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def counted(fn):
    """(fn's result, launches, plain versions on CUDA tensors) of one run
    from counts set to 0."""
    from rspc_tpu_torch import cuda_build

    cuda_build.reset_counts()
    out = fn()
    return out, dict(cuda_build.LAUNCHES), dict(cuda_build.PLAIN_ON_CUDA)


def timed_runs(what, run):
    """One warm-up, then ``TIMED_RUNS`` runs bracketed by synchronize;
    returns the run times (s)."""
    import torch

    t0 = time.perf_counter()
    run()
    log(f"{what} warm-up: {time.perf_counter() - t0:.3f} s")
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    log(f"{what} timed runs (s): " + ", ".join(f"{t:.4f}" for t in times))
    return times


def max_gt_err(seq, totals) -> float:
    t = totals.cpu().numpy()
    return float(max(np.abs(t[i - 1] - seq.gt_transform(i)).max() for i in range(1, N_FRAMES)))


def phase_edges5(dev, clouds):
    """BASELINE config 2: crop + 5-class labels of the 10 frames, batched."""
    import torch

    from rspc_tpu_torch.config import EdgeConfig
    from rspc_tpu_torch.ops.canny import _hysteresis_plain, canny_from_gradients_masks, hysteresis_cuda
    from rspc_tpu_torch.ops.edges import extract_organized_edges_batch
    from rspc_tpu_torch.ops.normals import estimate_normals

    crop = [c.center_crop_3_5() for c in clouds]
    cfg = EdgeConfig()

    def run():
        labels = extract_organized_edges_batch(crop, cfg)
        torch.cuda.synchronize()
        return labels

    labels, launches, plain = counted(run)
    log(f"config 2 launches in one labelling: {launches}; plain versions on CUDA "
        f"tensors: {plain}")
    if launches["hysteresis"] != 2 or any(launches[k] for k in ("nn_sweep", "nn_sweep_split")) \
            or any(plain.values()):
        raise AssertionError(f"config 2 kernels: {launches}, plain {plain}")
    times = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)

    # the high-curvature masks the labeller hands B3, and the same at
    # thresholds that light the class, through B3 against the plain version
    est = [estimate_normals(c, cfg) for c in crop]
    nrm, nv = torch.stack([e[0] for e in est]), torch.stack([e[1] for e in est])
    hc_masks = {}
    for name, th in (("default", (cfg.hc_canny_low_threshold, cfg.hc_canny_high_threshold)),
                     ("lit", HC_LIT)):
        strong, weak = (m.contiguous() for m in
                        canny_from_gradients_masks(nrm[..., 0], nrm[..., 1], *th, valid=nv))
        got = hysteresis_cuda(strong, weak)
        want = torch.stack([_hysteresis_plain(a, b) for a, b in zip(strong, weak)])
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"B3 on the {name} high-curvature masks: {bad} pixels differ")
        hc_masks[name] = (strong, weak, int(strong.sum()), int(weak.sum()), int(want.sum()))
    strong, weak = hc_masks["default"][:2]
    hc_ms = device_ms(lambda: hysteresis_cuda(strong, weak), 50)
    hc_plain = cuda_ms(lambda: [_hysteresis_plain(a, b) for a, b in zip(strong, weak)], 3)
    hc_bnd, hc_by = bound(3 * strong.numel(), 0)
    lit_ms = device_ms(lambda: hysteresis_cuda(*hc_masks["lit"][:2]), 50)

    # against the port's CPU run on the same clouds
    cpu = [c.map(lambda x: x.cpu()) for c in crop]
    want = extract_organized_edges_batch(cpu, cfg)
    depth_cfg = EdgeConfig(edge_types=DEPTH_TYPES)
    d_card = extract_organized_edges_batch(crop, depth_cfg).cpu()
    d_cpu = extract_organized_edges_batch(cpu, depth_cfg)
    if not torch.equal(d_card, d_cpu):
        raise AssertionError(f"depth classes: {int((d_card != d_cpu).sum())} pixels differ "
                             f"from the CPU run")
    got = labels.cpu()
    valid = torch.stack([c.valid for c in cpu])
    diff = [int((got[i] != want[i]).sum()) for i in range(len(crop))]
    limit = [EDGE_DIFF_FRAC * int(valid[i].sum()) for i in range(len(crop))]
    counts = [int((got == k).sum()) for k in range(6)]
    log(f"config 2: {len(crop)} x {CROP_H}x{CROP_W} labelled, pixels per class 0-5 {counts}; "
        f"depth classes equal to the CPU run; labels differing from the CPU run per frame "
        f"{diff} (limit 0.1% of valid pixels, {min(limit):.0f}-{max(limit):.0f})")
    if any(d > lim for d, lim in zip(diff, limit)):
        raise AssertionError(f"labels differ from the CPU run: {diff}")
    if counts[5] == 0 or sum(counts[1:4]) == 0:
        raise AssertionError(f"config 2 labels look empty: {counts}")
    log(f"config 2 labeller min wall {min(times):.4f} s (runs "
        + ", ".join(f"{t:.4f}" for t in times) + "); "
        f"B3 on the high-curvature masks (strong {hc_masks['default'][2]}, weak "
        f"{hc_masks['default'][3]}, out {hc_masks['default'][4]} pixels) {hc_ms:.4f} ms, "
        f"plain {hc_plain:.3f} ms, bound {hc_bnd:.5f} ms ({hc_by}); at thresholds "
        f"{HC_LIT} (strong {hc_masks['lit'][2]}, weak {hc_masks['lit'][3]}, out "
        f"{hc_masks['lit'][4]}) {lit_ms:.4f} ms; both bit-exact vs plain")
    return launches, {"ms_high_curvature_288x384": hc_ms,
                      "plain_ms_high_curvature_288x384": hc_plain,
                      "bound_ms_high_curvature_288x384": hc_bnd}


def replay_capture(seq, dev):
    """The rendered frames and their IMU stream as a replay recording
    (built as ``rspc_tpu/cli.py::_source`` builds it), through the capture
    loop ``get_clouds`` with ``CaptureConfig()``: (clouds, thetas)."""
    from rspc_tpu_torch.capture.replay import ReplaySource, get_clouds
    from rspc_tpu_torch.config import CaptureConfig

    depth, color = zip(*[(d.cpu().numpy().astype(np.uint16), c.cpu().numpy())
                         for d, c in seq.frames(dev)])
    stream, snap = seq.imu_stream(dev)
    data, ts = stream.data.cpu().numpy(), stream.ts.cpu().numpy()
    i = seq.intr
    src = ReplaySource({
        "depth": np.stack(depth), "color": np.stack(color), "ts": ts[snap],
        "gyro": data[snap - 1], "accel": data[snap],
        "intr": np.asarray([i.width, i.height, i.fx, i.fy, i.ppx, i.ppy], np.float32),
    })
    return get_clouds(src, N_FRAMES, CaptureConfig(), device=dev)


def phase_icp_edge(dev, seq, clouds, replay_thetas):
    """BASELINE config 3: the ICP-edge scheme with IMU guesses."""
    import torch

    from rspc_tpu_torch.presets import north_star_config
    from rspc_tpu_torch.registration.schemes import ICPEdgeBasedRegistration

    thetas = seq.thetas(device=dev)
    t_err = float(np.abs(thetas - replay_thetas).max())
    log(f"config 3 thetas (filter on the card) vs the capture loop's: max diff {t_err:.3e}")
    if not t_err <= 1e-6:
        raise AssertionError(f"thetas differ from get_clouds': {t_err:.3e}")
    config = north_star_config()

    def run():
        scheme = ICPEdgeBasedRegistration(thetas=thetas, config=config)
        result = scheme.registration(clouds)
        torch.cuda.synchronize()
        return scheme, result

    times = timed_runs("config 3", run)
    log("config 3 profile: " + device_profile(run))
    _, syncs = count_syncs(run)
    (scheme, result), launches, plain = counted(run)
    converged = [bool(f.converged) for _, f in scheme.results]
    err = max_gt_err(seq, scheme.total_transforms)
    log(f"config 3 min wall {min(times):.4f} s; converged {sum(converged)}/{len(converged)}; "
        f"max |T_est - T_gt| {err:.3e}; host syncs {syncs}; launches {launches}; plain "
        f"versions on CUDA tensors {plain}")
    if not all(converged) or not err < MAX_ERR:
        raise AssertionError(f"config 3: converged {converged}, max error {err:.3e}")
    if (launches["nn_sweep"] <= 0 or launches["hysteresis"] <= 0
            or launches["nn_sweep_split"] != 0 or any(plain.values())):
        raise AssertionError(f"config 3 kernels: {launches}, plain {plain}")
    if not np.isfinite(result.xyz.cpu().numpy()).all():
        raise AssertionError("config 3: non-finite global cloud")
    return launches


def phase_reference(dev, seq, clouds, thetas):
    """The ``--all`` path under the reference preset, on the replayed,
    cropped, BGR-swizzled clouds."""
    import dataclasses
    import os
    import tempfile

    import torch

    from rspc_tpu_torch.config import EdgeConfig, PipelineConfig
    from rspc_tpu_torch.io.pcd import load_pcd
    from rspc_tpu_torch.registration.schemes import (
        ICPEdgeBasedRegistration,
        NDTEdgeBasedRegistration,
    )

    base = PipelineConfig()
    if (clouds[0].height, clouds[0].width) != (CROP_H, CROP_W):
        raise AssertionError(f"replayed clouds are {clouds[0].height}x{clouds[0].width}")

    def run(config=base, dataset_dir=None, cls=ICPEdgeBasedRegistration, **kw):
        scheme = cls(config=config, dataset_dir=dataset_dir, **kw)
        result = scheme.registration(clouds)
        torch.cuda.synchronize()
        return scheme, result

    with tempfile.TemporaryDirectory() as tmp:
        times = timed_runs("reference preset",
                           lambda: run(dataset_dir=tmp, thetas=thetas))
        log("reference preset profile: " + device_profile(lambda: run(thetas=thetas)))
        _, syncs = count_syncs(lambda: run(thetas=thetas))
        (scheme, result), launches, plain = counted(lambda: run(dataset_dir=tmp, thetas=thetas))
        if (launches["nn_sweep"] <= 0 or launches["hysteresis"] != 2
                or launches["nn_sweep_split"] != 0 or any(plain.values())):
            raise AssertionError(f"reference preset kernels: {launches}, plain {plain}")
        totals = scheme.total_transforms
        if not torch.isfinite(totals).all():
            raise AssertionError("reference preset: non-finite totals")
        out = scheme._out
        stored = [out["edges_down0"]] + [out["features"].map(lambda x, i=i: x[i])
                                         for i in range(1, N_FRAMES)]
        files = sorted(os.listdir(tmp))
        want_files = sorted([f"edge-{i}.pcd" for i in range(N_FRAMES)] + ["edge_cloud.pcd"])
        if files != want_files:
            raise AssertionError(f"reference preset wrote {files}")
        for name, cloud in [(f"edge-{i}.pcd", c) for i, c in enumerate(stored)] + [
                ("edge_cloud.pcd", out["target"])]:
            back = load_pcd(os.path.join(tmp, name), device="cpu")
            v = cloud.valid.cpu()
            xyz, rgb = cloud.xyz.cpu()[v], cloud.rgb.cpu()[v]
            if not (torch.equal(back.xyz, xyz)
                    and torch.equal(back.rgb, torch.trunc(rgb.clamp(0, 255)))):
                raise AssertionError(f"{name} does not read back as stored")
        n_edge = [int(c.count()) for c in stored]

    converged = [bool(f.converged) for _, f in scheme.results]
    err = max_gt_err(seq, totals)
    loop_cfg = dataclasses.replace(base, use_scan=False)
    (loop, _), loop_syncs = count_syncs(lambda: run(loop_cfg, thetas=thetas))
    loop_t0 = time.perf_counter()
    run(loop_cfg, thetas=thetas)
    loop_wall = time.perf_counter() - loop_t0
    loop_conv = [bool(f.converged) for _, f in loop.results]
    path_diff = float((loop.total_transforms - totals).abs().max())
    rgb_cfg = dataclasses.replace(base, edge=EdgeConfig(edge_types=("rgb_canny",)))
    rgb_only, _ = run(rgb_cfg, thetas=thetas)
    log(f"reference preset min wall {min(times):.4f} s; converged {sum(converged)}/"
        f"{len(converged)}; max |T_est - T_gt| {err:.3e} (not gated); host syncs {syncs}; "
        f"launches {launches}; edge points per frame {n_edge}; "
        f"{len(want_files)} PCDs read back as stored; loop path: wall {loop_wall:.4f} s, "
        f"host syncs {loop_syncs}, converged {sum(loop_conv)}, max |T_fused - T_loop| "
        f"{path_diff:.3e}; RGB-only labeller totals equal: "
        f"{torch.equal(rgb_only.total_transforms, totals)}")
    if loop_conv != converged or not path_diff <= PATHS_TOL:
        raise AssertionError(f"fused and loop paths disagree: {path_diff:.3e}, "
                             f"{converged} vs {loop_conv}")
    if not torch.equal(rgb_only.total_transforms, totals):
        raise AssertionError("the RGB-only labeller changed the totals")
    if not np.isfinite(result.xyz.cpu().numpy()).all():
        raise AssertionError("reference preset: non-finite global cloud")

    t0 = time.perf_counter()
    ndt, _ = run(cls=NDTEdgeBasedRegistration, rads=YAW_STEP)
    ndt_wall = time.perf_counter() - t0
    ndt_conv = [bool(f.converged) for _, f in ndt.results]
    log(f"NDTEdgeBasedRegistration(rads={YAW_STEP}, PipelineConfig()) on the same clouds: "
        f"wall {ndt_wall:.4f} s (one run, first of its shapes); converged "
        f"{sum(ndt_conv)}/{len(ndt_conv)}; max |T_est - T_gt| "
        f"{max_gt_err(seq, ndt.total_transforms):.3e}")
    return launches


def read_png(path) -> np.ndarray:
    """The RGB8 pixels of a PNG that ``viz/png.py`` wrote (filter 0 rows)."""
    import struct
    import zlib

    data = open(path, "rb").read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if (raw[:, 0] != 0).any():
        raise AssertionError(f"{path}: unexpected PNG row filter")
    return raw[:, 1:].reshape(h, w, 3)


class spy:
    """Within the block, the function ``module.name`` records what it
    returns in ``self.got``."""

    def __init__(self, module, name):
        self.module, self.name, self.got = module, name, []

    def __enter__(self):
        orig = self.orig = getattr(self.module, self.name)

        def recorded(*a, **kw):
            out = orig(*a, **kw)
            self.got.append(out)
            return out
        setattr(self.module, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_cli(dev, card):
    """The ``rs-pcl`` commands through ``rspc_tpu_torch.cli.main`` on the
    CLI's default synthetic source (10 frames, 640x480, yaw -0.15 rad) in
    a temporary directory; each command from launch counts set to 0."""
    import contextlib
    import os
    import tempfile

    import torch

    from rspc_tpu_torch import cli, cuda_build
    from rspc_tpu_torch.capture import odometry
    from rspc_tpu_torch.capture.replay import get_clouds
    from rspc_tpu_torch.io import native
    from rspc_tpu_torch.io.dataset import load_dataset_clouds
    from rspc_tpu_torch.io.pcd import load_pcd
    from rspc_tpu_torch.ops.keypoints import compute_descriptors, detect_keypoints
    from rspc_tpu_torch.registration import schemes
    from rspc_tpu_torch.viz.render import render_cloud

    total = {k: 0 for k in cuda_build.LAUNCHES}
    walls = {}

    def command(argv, env=(), profile=False):
        """Run ``rspc-torch argv`` (rc 0 required): its launches and wall;
        with ``profile``, once more under the profiler for the card's busy
        time."""
        saved = {k: os.environ.get(k) for k, _ in env}
        os.environ.update(dict(env))
        try:
            cuda_build.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["rspc-torch", *argv])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, plain = dict(cuda_build.LAUNCHES), dict(cuda_build.PLAIN_ON_CUDA)
            rcs = [rc]
            busy = device_profile(lambda: rcs.append(cli.main(["rspc-torch", *argv]))) \
                if profile else ""
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        what = " ".join(argv) + "".join(f" ({k}={v})" for k, v in env)
        log(f"cli {what}: rc {rc}, wall {wall:.3f} s on {card}; launches {launches}; "
            f"plain versions on CUDA tensors {plain}" + (f"; profiled rerun: {busy}" if busy else ""))
        if any(rcs):
            raise AssertionError(f"rspc-torch {what} returned {rcs} (the run, the rerun)")
        if any(plain.values()):
            raise AssertionError(f"rspc-torch {what} ran a plain version on the card: {plain}")
        for k in total:
            total[k] += launches[k]
        walls[what] = wall
        return launches

    log(f"host codec: {'native ' + native.LIB_PATH if native.available() else 'Python fallback'}")
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        ds = os.path.join(tmp, "dataset")
        matches = os.path.join(tmp, "matches")

        # --capture, with the odometry (spied: good matches and poses per pair)
        with spy(odometry, "get_clouds_new") as runs, \
                spy(odometry, "match_descriptors") as matched:
            command(["--capture", "seq", str(CLI_FRAMES)],
                    env=[("RSPC_CAPTURE_MATCH_DIR", matches)], profile=True)
        pairs = runs.got[0]
        good = [int(g.sum()) for _, g in matched.got[:CLI_FRAMES - 1]]
        moves = [np.round(p[:3, 3], 4).tolist() for _, p in pairs[1:]]
        log(f"cli odometry: good matches per pair {good}; translation per pair {moves}")
        pcds = sorted(f for f in os.listdir(ds) if f.startswith("seq-"))
        pngs = sorted(os.listdir(matches))
        if len(pcds) != CLI_FRAMES or len(pngs) != CLI_FRAMES - 1:
            raise AssertionError(f"--capture wrote {pcds} and {pngs}")
        if min(good) < 3 or not all(np.isfinite(p).all() for _, p in pairs):
            raise AssertionError(f"odometry: good matches {good}")
        command(["--capture", "plain", str(CLI_FRAMES)], env=[("RSPC_CAPTURE_NO_ODOMETRY", "1")])
        for i in range(CLI_FRAMES):
            a = open(os.path.join(ds, f"seq-{i}.pcd"), "rb").read()
            if a != open(os.path.join(ds, f"plain-{i}.pcd"), "rb").read():
                raise AssertionError(f"seq-{i}.pcd depends on the odometry")

        # the odometry's features repeat bit for bit on the card
        gray = odometry._gray(load_pcd(os.path.join(ds, "seq-0.pcd"), device=dev).rgb)
        kp = [detect_keypoints(gray) for _ in range(2)]
        desc = [compute_descriptors(gray, k[0], k[2], k[3], num_orientations=3) for k in kp]
        if not (all(torch.equal(a, b) for a, b in zip(*kp))
                and all(torch.equal(a, b) for a, b in zip(*desc))):
            raise AssertionError("keypoints or descriptors differ between two runs")
        cpu_kp = detect_keypoints(gray.cpu())
        log(f"cli keypoints of seq-0 on the card: {int(kp[0][2].sum())} valid, two runs "
            f"equal bit for bit; on the CPU {int(cpu_kp[2].sum())} valid")

        # the full 5-class labeller, as in the JAX package
        # (rspc_tpu/ops/edges.py:236-256): B3 on the high-curvature and
        # on the RGB masks
        launches = command(["--edges", "seq-0.pcd"], profile=True)
        if launches["hysteresis"] != 2 or not os.path.getsize(
                os.path.join(ds, "seq-0.pcd.edges.png")):
            raise AssertionError(f"--edges: {launches}")

        rads = (CLI_DEG / 180.0) * np.pi
        launches = command(["--registration", "seq", str(CLI_DEG), str(CLI_FRAMES)],
                           profile=True)
        back = load_pcd(os.path.join(ds, "seq-registration"), device="cpu")
        api = schemes.NDTEdgeBasedRegistration(rads=rads).registration(
            load_dataset_clouds("seq", CLI_FRAMES, "dataset", device=dev))
        want = api.xyz[api.valid].cpu()
        reg_err = float((back.xyz - want).abs().max()) if back.xyz.shape == want.shape else None
        log(f"cli --registration: {back.xyz.shape[0]} points read back, the API run "
            f"{want.shape[0]}; max |diff| {reg_err}")
        if reg_err is None or not reg_err <= CLI_REG_TOL:
            raise AssertionError(f"--registration differs from the API run: {reg_err}")
        if launches["nn_sweep"] <= 0 or launches["hysteresis"] <= 0:
            raise AssertionError(f"--registration kernels: {launches}")

        command(["--view", "seq-0"], profile=True)
        img = read_png(os.path.join(ds, "seq-0.pcd.png"))
        c = load_pcd(os.path.join(ds, "seq-0.pcd"), device="cpu").flatten()
        cpu_img = render_cloud(c.xyz, c.rgb, c.valid).numpy()
        differ = int((img != cpu_img).any(-1).sum())
        log(f"cli --view: {img.shape[1]}x{img.shape[0]} PNG, {differ} pixels differ from "
            f"the CPU render")
        if differ > CLI_VIEW_TIE_FRAC * img.shape[0] * img.shape[1]:
            raise AssertionError(f"--view: {differ} pixels differ from the CPU render")

        launches = command(["--all", str(CLI_FRAMES), "out"], profile=True)
        back = load_pcd(os.path.join(ds, "out.pcd"), device="cpu")
        clouds, thetas = get_clouds(cli._source(None, CLI_FRAMES, dev), CLI_FRAMES, device=dev)
        api = schemes.ICPEdgeBasedRegistration(thetas=thetas).registration(clouds)
        want = api.xyz[api.valid].cpu()
        all_err = float((back.xyz - want).abs().max()) if back.xyz.shape == want.shape else None
        files = sorted(f for f in os.listdir(ds) if f.startswith(("edge", "out")))
        want_files = sorted(["out.pcd", "edge_cloud.pcd"]
                            + [f"edge-{i}.pcd" for i in range(CLI_FRAMES)])
        log(f"cli --all: {len(files)} PCDs; out.pcd {back.xyz.shape[0]} points read back, "
            f"the API run {want.shape[0]}; max |diff| {all_err}")
        if files != want_files:
            raise AssertionError(f"--all wrote {files}")
        if launches["hysteresis"] != 2 or launches["nn_sweep"] <= 0:
            raise AssertionError(f"--all kernels: {launches}")
        if all_err is None or not all_err <= CLI_ALL_TOL:
            raise AssertionError(f"--all differs from the API run: {all_err}")
    log(f"cli walls on {card}: " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    dev = torch.device("cuda:0")

    from rspc_tpu_torch import cuda_build

    t0 = time.perf_counter()
    cuda_build.build(verbose=True)
    cuda_build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")

    nn = phase_nn(dev)
    nn_stream = phase_nn_stream(dev)

    t0 = time.perf_counter()
    seq, clouds = render(dev, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    log(f"rendered {N_FRAMES} {WIDTH}x{HEIGHT} frames on the card in "
        f"{time.perf_counter() - t0:.3f} s")

    hyst = phase_hysteresis(dev, clouds)
    per_path = {"north star": phase_slice(dev, seq, clouds),
                "incremental": phase_incremental(dev, seq, clouds)}
    per_path["config 2"], hc = phase_edges5(dev, clouds)
    ref_clouds, ref_thetas = replay_capture(seq, dev)
    per_path["config 3"] = phase_icp_edge(dev, seq, clouds, ref_thetas)
    per_path["reference preset"] = phase_reference(dev, seq, ref_clouds, ref_thetas)
    per_path["cli"] = phase_cli(dev, card)
    log(f"launches per path (each from counts set to 0): {per_path}")
    launches = {k: sum(p[k] for p in per_path.values()) for k in per_path["north star"]}

    if "jax" in sys.modules or "rspc_tpu" in sys.modules:
        raise AssertionError("the port imported jax or rspc_tpu")
    kernels = [
        {"name": "nn_sweep", "route": "cuda",
         "source": "rspc_tpu_torch/csrc/nn_sweep.cu",
         "replaces": "rspc_tpu/ops/nn_pallas.py:48",
         "launches": launches["nn_sweep"], **nn},
        {"name": "nn_sweep_split", "route": "cuda",
         "source": "rspc_tpu_torch/csrc/nn_sweep.cu",
         "replaces": "rspc_tpu/ops/nn_pallas.py:112",
         "launches": launches["nn_sweep_split"], **nn_stream},
        {"name": "hysteresis", "route": "cuda",
         "source": "rspc_tpu_torch/csrc/hysteresis.cu",
         "replaces": "rspc_tpu/ops/canny.py:103",
         "launches": launches["hysteresis"], **hyst, **hc},
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
