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
     routes every sweep to B2: one warm-up and timed runs, a run traced
     by the program's own spans (host seconds by span, the ``sync.*``
     counts), and one counted run that must launch
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
     within 1e-5 of the API run); ``--registration seq -9 10 --preset
     robust`` (within 1e-4 m of ``robust_config(anchor_mode="map")``
     through the API) and ``--all 10 out --preset auto`` (within 1e-5 m
     of ``auto_register`` through the API);
 12. the robust stack on the robustness matrix's scenes
     (``benchmarks/robustness.py``, 10 x 640x480, seed 0, rendered on the
     card): ``robust_config(anchor_mode="map")`` on ``partial_overlap``,
     ``color=True`` on ``combined``, ``pose_graph=True`` (IMU thetas,
     skips {1, 2, 3} and the closures) on ``loop_drift``, and the first
     again on the ``use_scan=False`` loop: every pair converged and max
     |T_est - T_gt| within max(2 x ref, ref + 2e-3), ref the JAX
     package's record (``benchmarks/records_matrix_r5_seed0.jsonl``) or,
     where the JAX package on the CPU misses it, its CPU figure
     (``ROBUST_JAX_CPU``),
     each run from counts set to 0 once (the robust path's launches),
     then timed once, with its host syncs, a profile and how often the
     rescue's gate fired; B1 against its plain version at the map
     anchor's last step and at a pose-graph pair, on those runs' clouds;
 13. ``auto_register`` on ``clean`` (the fast path keeps the north star,
     not escalated) and on ``loop_drift`` (escalated, ``robust_map``),
     held to ``benchmarks/records_auto_fastpath.jsonl`` the same way
     (``AUTO_JAX_CPU``);
     the other six scenes' selections and scores printed, not gated;
 14. ``serving``: ``parallel/chain.py::batched_registration`` without a
     mesh at B = 1, 2, 4 sequences of 10 x 640x480 frames
     (benchmarks/serving.py: yaw -0.08 - 0.01 i rad per frame,
     ``north_star_config()``, static accumulated-yaw guesses, no global
     cloud): each sequence's totals equal one ``_registration_fused`` run
     on it bit for bit, 9/9 converged, each within 1e-3 of the truth or,
     where the JAX package on the CPU misses 1e-3 on that sequence
     (yaw -0.11), within max(2 x its figure, its figure + 2e-3)
     (``SERVE_JAX_CPU``);
     sequences/s is B over the min of 3 timed runs after the counted one,
     printed with the card's name and power limit;
 15. ``scaleout``: NCCL at world size 1 in this process
     (``points_sharded_registration`` of the north star equals
     ``_registration_fused`` bit for bit), then two gloo ranks on cuda:0,
     each a process running ``chip_smoke.py --scaleout-rank`` (gloo
     all-reduces of CUDA tensors; ``make_mesh`` over ``("points",)``, ``(1,
     2)`` and ``("data",)``): the sharded NN at 5,120 x 102,400 equal to
     the unsharded B1 sweep, sharded ICP and NDT within 1e-5 of one rank,
     the points-sharded north star 9/9 within 1e-3 of the truth and 1e-4
     of one rank, the data-sharded B = 2 batch equal to the unsharded one;
     both ranks must agree. Two ranks on one card measure nothing about
     scale-out: their walls are printed as that;
 16. ``ndt_modes``: the north star three ways, each from counts set to 0
     after a warm-up, its wall and host syncs printed: NDT's frozen line
     search (the default), ``pcl_exact_line_search=True`` (9/9 within
     1e-3 of the truth, totals within 1e-3 of the frozen run's) and
     ``sweep_cells=512`` (9/9, totals within 1e-4 of the gather path's);
     then the first NDT pair at the PCL default neighbourhood (27 cells)
     with ``sweep_cells=-1`` (auto, 512) against the gather path (1e-5),
     and each line search's host syncs per Newton step on it; then
     tests/test_parallel.py's cube case in each mode against the port's
     CPU run (``CUBE_MODES``);
 17. ``input_side`` on frame 0 (640x480): ``passthrough`` against its
     numpy mask and ``statistical_outlier_removal(mean_k=50,
     stddev_mult=1.5)`` on all 307,200 slots against a scipy ``cKDTree``
     oracle (equal but for points within 1e-6 of the threshold);
     ``estimate_normals_radius`` at r = 0.05 and 0.1 on the frame's 2 cm
     voxel cloud against a float64 ``query_ball_point`` oracle (valid
     masks equal, |cos| >= 0.999 where the neighbourhood's two smallest
     eigenvalues differ by 1e-5 m^2 or more); ``deproject_depth`` with
     Brown-Conrady coefficients (0.1, -0.05, 0.001, 0.001, 0.01) undone
     to 2e-4 against the numpy forward model; ``render_trajectory`` of
     the exact run's totals at 640x480 against the port's CPU render (at
     most 0.1% of the pixels apart); ``python -m
     rspc_tpu_torch.examples.pcd_visualization`` on a PCD of the voxel
     cloud (rc 0, the PNG read back). Each wall is printed;
 18. ``feature_quality``: the port's ``tools/feature_quality.py`` on the
     card (its synthetic frame 0 at 320x240, the four warps of
     ``homographies`` through its ``warp_perspective``): every warp at
     ratios 0.3 and 0.7 with the odometry's options, ``first_octave=0``
     on ``shift`` and ``rotate8`` and ``scale_gate=1.5`` on
     ``scale1.12`` at 0.3. Each row twice on the card (features and
     matches equal bit for bit) and once on the CPU (repeatability and
     inlier rate within 0.02, matches within 3 of the card's; both rows
     printed); at ratio 0.3 the default rows meet the floors of
     tests/test_feature_quality.py; ``python -m
     rspc_tpu_torch.tools.feature_quality`` as a process (rc 0, its
     rows printed). No kernel launches;
 19. ``config1`` (run after config 2): BASELINE config 1
     (``benchmarks/workloads.py:82-107``), frames 0 and 1 flattened,
     ``voxel_downsample(c, 0.02, 10240)`` as set-up, ``icp_align(down[1],
     down[0], ICPConfig(), static_y_guess(yaw))`` timed: the min wall of
     3 after a warm-up, the host syncs, B1's shape and its launches in
     one run from counts set to 0 (no plain sweep on the card); converged, with
     fitness and transform within 1e-4 of the port's CPU run of the same
     clouds.

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
# the incremental cells' sweep: a 1 cm voxel grid's 307,200 slots of a
# VGA frame, its occupied voxels a prefix (140,000-216,000; PERF.md §4)
CELL_SRC, CELL_SRC_LIVE = WIDTH * HEIGHT, 165_000
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
# The JAX package's accuracy records, seed 0 (max |T_est - T_gt|, taken
# at an earlier commit): benchmarks/records_matrix_r5_seed0.jsonl (the
# robust presets) and benchmarks/records_auto_fastpath.jsonl (auto).
ROBUST_RECORDS = {"partial_overlap": 3.636e-3, "combined": 5.210e-2, "loop_drift": 1.753e-2}
AUTO_RECORDS = {"clean": 3.290e-4, "loop_drift": 1.936e-2}
# Where the JAX package as it stands misses its record on the CPU at
# 640x480, end to end on its own jitted program, a run is gated against
# that figure instead (tests/torch_reference_parity.py robust; PERF.md
# section 6); on partial_overlap it meets the record (3.067e-3)
ROBUST_JAX_CPU = {"combined": 1.031e-1, "loop_drift": 4.717e-2}
AUTO_JAX_CPU = {"loop_drift": 6.397e-2}
# serving and scale-out: benchmarks/serving.py's batch sizes; two gloo
# ranks on the one card; sharded solves vs one rank (f32 sums in another
# order), the points-sharded chain vs one rank
SERVE_BATCHES = (1, 2, 4)
# the JAX package's max |T - T_gt| on each serving sequence, at 640x480
# on the CPU through its batched_registration
# (tests/torch_reference_parity.py serving; PERF.md section 6): it meets
# 1e-3 on yaws -0.08 to -0.10 and misses it on yaw -0.11, which is then
# gated as the robust phase gates a missed record
SERVE_JAX_CPU = (3.534e-4, 4.188e-4, 8.801e-4, 1.0911e-3)
SCALE_RANKS = 2
SCALE_TOL = 1e-5
SCALE_CHAIN_TOL = 1e-4
SCALE_TIMEOUT_S = 300
NDT_EXACT_DELTA = 1e-3  # exact against frozen line search totals (JAX: 1.1e-5, RESULTS.md)
NDT_SWEEP_TOL = 1e-4  # compact-cell sweep against gather path totals
NDT_PAIR_TOL = 1e-5  # one pair, auto sweep vs gather (the JAX test's 5e-6, f32 on the card)
# tests/test_parallel.py's NDT case: 1,024 points in a 4 m cube moved by a
# 0.05 rad yaw and a shift, on a 16^3 grid, in each NDT mode (the sweep
# with every valid cell compacted), held card against CPU. Its last
# Newton steps are decided below one ulp of the score: the sweep reduces
# 1,024 cells per point in another order on the card and takes one step
# fewer there, within one step's length (4.06e-4; PERF.md section 6)
CUBE_MODES = {"gather": {}, "exact": {"pcl_exact_line_search": True},
              "sweep": {"sweep_cells": 1024}}
CUBE_TOL = 1e-5
CUBE_SWEEP_TOL = 5e-4
# BASELINE config 1 (benchmarks/workloads.py:82-107): frames 0 and 1,
# voxel-downsampled, point-to-point ICP with the reference defaults,
# held against the port's CPU run of the same clouds
CONFIG1_LEAF, CONFIG1_CAP = 0.02, 10_240
CONFIG1_TOL = 1e-4
UNDISTORT_TOL = 2e-4  # tests/test_image_ops.py's round-trip bound
NORMAL_GAP = 1e-5  # m^2: below this eigenvalue gap a radius normal is held by NORMAL_RQ_TOL
NORMAL_RQ_TOL = 1e-7  # m^2: n^T C n above the smallest eigenvalue (the f32 moment error)
# the feature-quality phase: tests/test_feature_quality.py's floors at
# ratio 0.3 (repeatability, matches, inlier rate; perspective has no
# repeatability floor), the options the odometry does not set, and how far
# a card row may lie from the port's CPU row of the same frames (the CPU
# tests' allowance against the JAX package,
# tests/test_torch_feature_quality.py)
FQ_RATIOS = (0.3, 0.7)
FQ_FLOORS = {"shift": (0.9, 100, 0.95), "rotate8": (0.65, 30, 0.9),
             "scale1.12": (0.7, 35, 0.85), "perspective": (None, 30, 0.9)}
FQ_OPTIONS = (("shift", {"first_octave": 0}), ("rotate8", {"first_octave": 0}),
              ("scale1.12", {"scale_gate": 1.5}))
FQ_REP_TOL, FQ_MATCH_TOL, FQ_INLIER_TOL = 0.02, 3, 0.02


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


def plan_line(args, dev) -> str:
    """The NN sweep's plan on ``args`` as one phrase: the mirror of the
    plan the kernel makes on the device over the live source prefix."""
    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.ops.nn import SRC_TILE, card_plan

    rows = args[1].nonzero()
    src_live = int(rows[-1, 0]) + 1 if rows.numel() else 0
    p = card_plan(args[0].shape[0], dev, src_live)
    resident = cuda_build.nn_sweep_resident()
    slots = torch.cuda.get_device_properties(dev).multi_processor_count * resident
    return (f"plan: {p.tiles} live tiles of {SRC_TILE} sources (src_live {src_live}) x "
            f"{p.splits} splits = {p.tiles * p.splits} of {p.blocks} blocks on {slots} "
            f"resident slots ({resident} per SM)")


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


def nn_kernel_only(args):
    """The NN sweep's kernel alone (the key fill and both passes,
    ``ops/nn.py::_launch``) on ``args`` packed once by the wrappers'
    ``_pack``: a closure for ``cuda_ms``. Bypasses the wrappers, so it
    counts no launch."""
    from rspc_tpu_torch.ops.nn import _launch, _pack

    packed = _pack(*args)
    return lambda: _launch(*packed)


def phase_nn(dev):
    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.ops.nn import nearest_neighbors, nearest_neighbors_cuda
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
    ms = cuda_ms(nn_kernel_only(args), 50)
    wrap_ms = cuda_ms(lambda: nearest_neighbors_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: nearest_neighbors(*args, chunk=4096), 5)
    lib_ms = cuda_ms(lambda: torch.cdist(args[0], args[2]).min(dim=1), 5)
    bnd = nn_bound(*args)
    log(f"B1 main shape {NN_SRC} x {NN_TGT_CAP} (live {NN_TGT_LIVE}), "
        f"{plan_line(args, dev)}: max |dist2 kernel - plain| {err:.3e}; kernel {ms:.4f} ms "
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
    a_ms = cuda_ms(nn_kernel_only(a_args), 50)
    a_wrap = cuda_ms(lambda: nearest_neighbors_cuda(*a_args), 20)
    a_plain = cuda_ms(lambda: nearest_neighbors(a_src, a_sv, a_tgt, a_tv, 2048), 5)
    a_lib = cuda_ms(lambda: torch.cdist(a_src, a_tgt).min(dim=1), 5)
    a_bnd = nn_bound(a_src, a_sv, a_tgt, a_tv)
    log(f"B1 anchor shape {9 * 3414} x 10240, {plan_line(a_args, dev)}: "
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
    r_ms = cuda_ms(nn_kernel_only(r_args), 20)
    r_wrap = cuda_ms(lambda: nearest_neighbors_cuda(*r_args), 10)
    r_plain = cuda_ms(lambda: nearest_neighbors(*r_args, chunk=4096), 2)
    r_lib = cuda_ms(lambda: torch.cdist(r_args[0], r_args[2]).min(dim=1), 2)
    r_bnd = nn_bound(*r_args)
    log(f"B1 reference-preset shape {REF_SRC} x {REF_TGT_CAP} (live {REF_TGT_LIVE}), "
        f"{plan_line(r_args, dev)}: max |dist2 kernel - plain| {r_err:.3e}; "
        f"kernel {r_ms:.4f} ms (wrapper {r_wrap:.3f} ms), plain {r_plain:.3f} ms, "
        f"torch.cdist+min {r_lib:.3f} ms, bound {r_bnd['bound_ms']:.4f} ms "
        f"({r_bnd['bound_by']})")
    return {"max_abs_err": max(err, a_err, r_err), "ms": ms, "wrapper_ms": wrap_ms,
            "plain_ms": plain_ms, **bnd, "library_ms": lib_ms,
            "ms_reference_shape": r_ms, "bound_ms_reference_shape": r_bnd["bound_ms"]}


def phase_nn_stream(dev):
    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.ops.nn import nearest_neighbors, nearest_neighbors_stream_cuda
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
    ms = cuda_ms(nn_kernel_only(args), 10)
    wrap_ms = cuda_ms(lambda: nearest_neighbors_stream_cuda(*args), 10)
    plain_ms = cuda_ms(lambda: nearest_neighbors(*args, chunk=4096), 1)
    bnd = nn_bound(*args)
    log(f"B2 last-pair shape {INC_SRC} x {INC_TGT_CAP} (live {INC_TGT_LIVE}), "
        f"{plan_line(args, dev)}: max |dist2 kernel - plain| {err:.3e}; kernel {ms:.3f} ms "
        f"(wrapper {wrap_ms:.3f} ms), plain {plain_ms:.3f} ms, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); "
        f"no library call (a {INC_SRC} x {INC_TGT_LIVE} distance matrix is "
        f"{INC_SRC * INC_TGT_LIVE * 4 / 1e9:.0f} GB)")
    cell = nn_cell_shape(dev, tgt, tv, rng)
    return {"max_abs_err": max(err, cell["err"]), "ms": ms, "wrapper_ms": wrap_ms,
            "plain_ms": plain_ms, **bnd, "library_ms": None, "ms_cell_shape": cell["ms"],
            "bound_ms_cell_shape": cell["bound_ms"]}


def nn_cell_shape(dev, tgt, tv, rng):
    """B2 at the incremental cells' shape: ``CELL_SRC`` voxel slots whose
    first ``CELL_SRC_LIVE`` are valid against the 10-frame map (``tgt``,
    ``tv``: 3,072,000 rows, 2,764,800 live), against the plain sweep."""
    import torch

    from rspc_tpu_torch.ops.nn import nearest_neighbors, nearest_neighbors_stream_cuda

    live = np.flatnonzero(tv)
    src = np.zeros((CELL_SRC, 3), np.float32)
    src[:CELL_SRC_LIVE] = (tgt[rng.choice(live, CELL_SRC_LIVE)]
                           + rng.normal(0, 0.01, (CELL_SRC_LIVE, 3))).astype(np.float32)
    sv = np.zeros(CELL_SRC, bool)
    sv[:CELL_SRC_LIVE] = True
    args = [torch.from_numpy(a).to(dev) for a in (src, sv, tgt, tv)]
    t0 = time.perf_counter()
    err = nn_vs_plain("B2 cell shape", args, nearest_neighbors_stream_cuda(*args), 4096)
    plain_s = time.perf_counter() - t0
    ms = cuda_ms(nn_kernel_only(args), 3)
    bnd = nn_bound(*args)
    log(f"B2 cell shape {CELL_SRC} ({CELL_SRC_LIVE} valid) x {tgt.shape[0]} "
        f"({int(tv.sum())} valid), {plan_line(args, dev)}: max |dist2 kernel - plain| "
        f"{err:.3e}; kernel {ms:.3f} ms, plain with the kernel's run {plain_s:.1f} s, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
        f"{100 * bnd['bound_ms'] / ms:.1f}%)")
    return {"err": err, "ms": ms, **bnd}


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
    time of the largest kernels. Information only, never a gate. Reads
    the profiler's raw events (building its event tree takes minutes on
    the robust runs' 150k-230k events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev_events = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        return "the profiler saw no device events"
    busy, end = 0.0, float("-inf")
    per_name = {}
    for name, start, stop in sorted(dev_events, key=lambda e: e[1]):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        per_name[name] = per_name.get(name, 0.0) + (stop - start)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
    sweep = [e for e in dev_events if "nn_sweep_pass" in e[0]]
    sweep_ms = sum(stop - start for _, start, stop in sweep) / 1e3
    b3 = {}
    for name, start, stop in dev_events:
        for p in B3_PASSES:
            if p in name:
                b3[p] = b3.get(p, 0.0) + (stop - start) / 1e3
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


def traced_stages(fn):
    """One run of ``fn`` traced by the program's own spans
    (``rspc_tpu_torch/utils/profiling.py``): (host seconds by span name,
    longest first, and the ``sync.*`` counts)."""
    from rspc_tpu_torch.utils import profiling

    profiling.enable()
    try:
        fn()
    finally:
        profiling.disable()
    out = profiling.collect()
    secs: dict = {}
    for sp in out["spans"]:
        secs[sp["name"]] = secs.get(sp["name"], 0.0) + (sp["end_ns"] - sp["start_ns"]) * 1e-9
    syncs = {k: v for k, v in out["counters"].items() if k.startswith("sync.")}
    return dict(sorted(secs.items(), key=lambda kv: -kv[1])), syncs


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
    secs, syncs = traced_stages(run)
    log("incremental spans (host s, summed by name): "
        + ", ".join(f"{k} {v:.4f}" for k, v in secs.items()) + f"; host syncs {syncs}")

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
        f"{pair_diff:.3e}; valid {int(result.count())} vs {int(b1_result.count())}")
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


def pair_errs(seq, totals) -> np.ndarray:
    """max |T_est - T_gt| of each pair."""
    t = totals.cpu().numpy()
    return np.array([np.abs(t[i - 1] - seq.gt_transform(i)).max() for i in range(1, N_FRAMES)])


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


def scenarios():
    """The robustness matrix's scenes (``benchmarks/robustness.py:35-106``,
    with the port's ``DepthNoise``): name -> ``SyntheticSequence``
    keyword arguments."""
    from rspc_tpu_torch.capture.synthetic import DepthNoise

    mild = DepthNoise(lateral_px=0.5, dropout=0.02)
    heavy = DepthNoise(axial_a=0.002, axial_b=0.004, lateral_px=1.0, dropout=0.10)
    out_back = (0, 1, 2, 3, 4, 5, 4, 3, 2, 1)
    return {
        "clean": {},
        "noise_mild": {"noise": mild},
        "noise_heavy": {"noise": heavy},
        "partial_overlap": {"yaw_step": -0.25, "translation_step": (0.12, 0.0, 0.08)},
        "low_texture": {"texture_contrast": 0.15},
        "combined": {"noise": mild, "yaw_step": -0.25, "translation_step": (0.10, 0.0, 0.06),
                     "texture_contrast": 0.3},
        "loop_return": {"noise": heavy, "yaw_schedule": tuple(-0.15 * y for y in out_back)},
        "loop_drift": {"noise": mild, "texture_contrast": 0.3,
                       "yaw_schedule": tuple(-0.2 * y for y in out_back),
                       "translation_schedule": tuple((0.09 * y, 0.0, 0.05 * y)
                                                     for y in out_back)},
    }


def scenario(name, dev):
    """(sequence, clouds on the card, the scheme's guess keywords, the
    pose graph's skips) of one robustness scene at 10 x 640x480, seed 0,
    as ``benchmarks/robustness.py:141-170`` builds them: rads for the
    linear trajectories; for the scheduled ones the IMU thetas and the
    skips {1, 2, 3} with the equal-yaw closure offsets."""
    from rspc_tpu_torch.capture.synthetic import SyntheticSequence
    from rspc_tpu_torch.ops.deproject import Intrinsics

    kw = dict(scenarios()[name])
    yaw = kw.pop("yaw_step", YAW_STEP)
    seq = SyntheticSequence(n_frames=N_FRAMES, yaw_step=yaw, seed=0,
                            intr=Intrinsics.simple(WIDTH, HEIGHT), **kw)
    clouds = seq.clouds(device=dev)
    if "yaw_schedule" not in kw:
        return seq, clouds, {"rads": yaw}, None
    yaws = kw["yaw_schedule"]
    closure = {j - i for i in range(N_FRAMES) for j in range(i + 1, N_FRAMES)
               if abs(yaws[i] - yaws[j]) < 1e-9}
    return seq, clouds, {"thetas": seq.thetas(device=dev)}, tuple(sorted({1, 2, 3} | closure))


def record_gate(record: float, jax_cpu: float = 0.0) -> float:
    """max(2 x ref, ref + 2e-3), ref the record or, where the JAX
    package on the CPU misses it, the JAX package's figure."""
    ref = max(record, jax_cpu)
    return max(2.0 * ref, ref + 2e-3)


def phase_robust(dev):
    """The robust stack: the three robust presets on their scenes and the
    robust preset's loop path, each held to the matrix's record or, where
    the JAX package on the CPU misses it, to the JAX package's figure
    (``record_gate``), and B1 at the map anchor's and a pose-graph pair's
    shapes against its plain version. Returns (launches of the robust
    path, the B1 entries)."""
    import dataclasses

    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.presets import robust_config
    from rspc_tpu_torch.registration import pairsteps
    from rspc_tpu_torch.registration.schemes import NDTEdgeBasedRegistration

    runs = [  # (label, scene, config, record, the JAX package's CPU figure)
        ("robust_map", "partial_overlap", robust_config(anchor_mode="map"),
         ROBUST_RECORDS["partial_overlap"], 0.0),
        ("robust_color", "combined", robust_config(anchor_mode="map", color=True),
         ROBUST_RECORDS["combined"], ROBUST_JAX_CPU["combined"]),
        ("robust_graph", "loop_drift", robust_config(anchor_mode="map", pose_graph=True),
         ROBUST_RECORDS["loop_drift"], ROBUST_JAX_CPU["loop_drift"]),
        ("robust_map loop path", "partial_overlap",
         dataclasses.replace(robust_config(anchor_mode="map"), use_scan=False),
         ROBUST_RECORDS["partial_overlap"], 0.0),
    ]
    scenes = {}
    for _, scene, *_ in runs:
        if scene not in scenes:
            scenes[scene] = scenario(scene, dev)

    def run_of(scene, cfg):
        seq, clouds, guess_kw, skips = scenes[scene]
        if cfg.refine.pose_graph:
            cfg = dataclasses.replace(cfg, refine=dataclasses.replace(
                cfg.refine, pose_graph_skips=skips))

        def run():
            scheme = NDTEdgeBasedRegistration(config=cfg, **guess_kw)
            result = scheme.registration(clouds)
            torch.cuda.synchronize()
            return scheme, result
        return run

    # the path's launches: every run once, from counts set to 0; the
    # rescue's gate is counted by spying on it
    fired = []
    orig = pairsteps._rescue_from

    def spied(*a, **kw):
        rel, need = orig(*a, **kw)
        fired.append(need)
        return rel, need

    pairsteps._rescue_from = spied
    try:
        cuda_build.reset_counts()
        results = {}
        for label, scene, cfg, *_ in runs:
            n0 = len(fired)
            results[label] = run_of(scene, cfg)() + (
                sum(bool(f) for f in fired[n0:]), len(fired) - n0)
        launches, plain = dict(cuda_build.LAUNCHES), dict(cuda_build.PLAIN_ON_CUDA)
    finally:
        pairsteps._rescue_from = orig
    log(f"robust launches (every run once): {launches}; plain versions on CUDA tensors "
        f"{plain}")
    if launches["nn_sweep"] <= 0 or launches["hysteresis"] <= 0 or any(plain.values()):
        raise AssertionError(f"robust path kernels: {launches}, plain {plain}")

    failures = []
    for label, scene, cfg, record, jax_cpu in runs:
        gate = record_gate(record, jax_cpu)
        scheme, result, n_fired, n_gates = results[label]
        seq = scenes[scene][0]
        converged = [bool(f.converged) for _, f in scheme.results]
        err = max_gt_err(seq, scheme.total_transforms)
        run = run_of(scene, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        _, syncs = count_syncs(run)
        log(f"{label} on {scene}: wall {wall:.4f} s (after one run); converged "
            f"{sum(converged)}/{len(converged)}; max |T_est - T_gt| {err:.4e} (record "
            f"{record:.4e}, the JAX package on the CPU {jax_cpu or 'meets it'}, gate "
            f"{gate:.4e}); per pair {np.round(pair_errs(seq, scheme.total_transforms), 5).tolist()}; "
            f"rescue gate fired {n_fired} of "
            f"{n_gates}; host syncs {syncs}; anchor accepted "
            f"{scheme.anchor_accepted.tolist() if scheme.anchor_accepted is not None else None}")
        log(f"{label} profile: " + device_profile(run))
        if not all(converged) or not err <= gate:
            failures.append(f"{label}: converged {converged}, max error {err:.4e}")
        if not torch.isfinite(result.xyz).all():
            failures.append(f"{label}: non-finite global cloud")
    if failures:
        raise AssertionError("; ".join(failures))

    nn = robust_nn_shapes(dev, results["robust_map"][0], results["robust_graph"][0])
    return launches, nn


def robust_nn_shapes(dev, map_scheme, graph_scheme):
    """B1 against its plain version at the map anchor's last step (one
    frame's 10,240-slot refine cloud against the map of the 9 frames
    before it, 102,400 slots) and at a pose-graph pair (3,414 strided
    sources against a 10,240-slot frame), on the runs' own clouds placed
    by their totals; each timed with its bound and ``torch.cdist``."""
    import torch

    from rspc_tpu_torch.ops.nn import nearest_neighbors, nearest_neighbors_cuda
    from rspc_tpu_torch.ops.transform import apply_transform

    out = {}
    full, totals = map_scheme._out["full_down"], map_scheme.total_transforms
    eye = torch.eye(4, device=dev)
    poses = torch.cat([eye[None], totals])
    placed = torch.stack([apply_transform(poses[i], full.xyz[i]) for i in range(N_FRAMES)])
    m = full.valid.shape[1]
    map_xyz = torch.zeros((N_FRAMES * m, 3), device=dev)
    map_val = torch.zeros((N_FRAMES * m,), dtype=torch.bool, device=dev)
    map_xyz[:(N_FRAMES - 1) * m] = placed[:-1].reshape(-1, 3)
    map_val[:(N_FRAMES - 1) * m] = full.valid[:-1].reshape(-1)
    g_full, g_tot = graph_scheme._out["full_down"], graph_scheme.total_transforms
    step = -(-m // graph_scheme.config.refine.anchor_max_points)
    shapes = {
        "map_anchor": (placed[-1], full.valid[-1], map_xyz, map_val, 16384),
        "pose_graph": (apply_transform(g_tot[0], g_full.xyz[1][::step]),
                       g_full.valid[1][::step], g_full.xyz[0], g_full.valid[0], 16384),
    }
    for name, (*args, chunk) in shapes.items():
        args = [a.contiguous() for a in args]
        err = nn_vs_plain(f"B1 {name} shape", args, nearest_neighbors_cuda(*args), chunk)
        ms = cuda_ms(nn_kernel_only(args), 50)
        wrap = cuda_ms(lambda: nearest_neighbors_cuda(*args), 20)
        plain = cuda_ms(lambda: nearest_neighbors(*args, chunk=chunk), 3)
        lib = cuda_ms(lambda: torch.cdist(args[0], args[2]).min(dim=1), 3)
        bnd = nn_bound(*args)
        log(f"B1 {name} shape {args[0].shape[0]} ({int(args[1].sum())} valid) x "
            f"{args[2].shape[0]} ({int(args[3].sum())} valid), {plan_line(args, dev)}: "
            f"max |dist2 kernel - plain| {err:.3e}; kernel {ms:.4f} ms (wrapper {wrap:.3f} ms), "
            f"plain {plain:.3f} ms, torch.cdist+min {lib:.3f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}, {100 * bnd['bound_ms'] / ms:.1f}%)")
        out[name] = {"err": err, "ms": ms, "plain_ms": plain, "library_ms": lib, **bnd}
    return out


def phase_auto(dev, card):
    """``auto_register`` on the clean scene (the fast path keeps the north
    star) and on ``loop_drift`` (it escalates and keeps ``robust_map``),
    each held to its record; then, without a gate, the other scenes'
    selections and scores. Returns the auto path's launches."""
    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.registration.auto import auto_register

    gated = {"clean": ("north_star", False, AUTO_RECORDS["clean"], 0.0),
             "loop_drift": ("robust_map", True, AUTO_RECORDS["loop_drift"],
                            AUTO_JAX_CPU["loop_drift"])}
    scenes = {name: scenario(name, dev) for name in gated}

    def run_of(name):
        _, clouds, guess_kw, _ = scenes[name]

        def run():
            ar = auto_register(clouds, **guess_kw)
            torch.cuda.synchronize()
            return ar
        return run

    cuda_build.reset_counts()
    results = {name: run_of(name)() for name in gated}
    launches, plain = dict(cuda_build.LAUNCHES), dict(cuda_build.PLAIN_ON_CUDA)
    log(f"auto launches (each gated scene once): {launches}; plain versions on CUDA "
        f"tensors {plain}")
    if launches["nn_sweep"] <= 0 or launches["hysteresis"] <= 0 or any(plain.values()):
        raise AssertionError(f"auto path kernels: {launches}, plain {plain}")
    failures = []
    for name, (want, escalated, record, jax_cpu) in gated.items():
        gate = record_gate(record, jax_cpu)
        ar = results[name]
        seq = scenes[name][0]
        converged = [bool(f.converged) for _, f in ar.scheme.results]
        err = max_gt_err(seq, ar.total_transforms)
        run = run_of(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        _, syncs = count_syncs(run)
        log(f"auto on {name}: selected {ar.selected} (record {want}), escalated "
            f"{ar.escalated} (record {escalated}), closures {ar.closures}, texture "
            f"{ar.texture:.4f}, scores {ar.scores}; converged {sum(converged)}/"
            f"{len(converged)}; max |T_est - T_gt| {err:.4e} (record {record:.4e}, the JAX "
            f"package on the CPU {jax_cpu or 'meets it'}, gate {gate:.4e}); wall {wall:.4f} s "
            f"(after one run) on {card}; "
            f"host syncs {syncs}")
        log(f"auto on {name} profile: " + device_profile(run))
        if (ar.selected != want or bool(ar.escalated) != escalated or not all(converged)
                or not err <= gate):
            failures.append(f"auto on {name}: {ar.selected}, escalated {ar.escalated}, "
                            f"converged {converged}, error {err:.4e}")
    if failures:
        raise AssertionError("; ".join(failures))
    for name in scenarios():
        if name in gated:
            continue
        seq, clouds, guess_kw, _ = scenario(name, dev)
        t0 = time.perf_counter()
        ar = auto_register(clouds, **guess_kw)
        torch.cuda.synchronize()
        conv = sum(bool(f.converged) for _, f in ar.scheme.results)
        log(f"auto on {name} (not gated): selected {ar.selected}, escalated {ar.escalated}, "
            f"scores {ar.scores}; converged {conv}/{N_FRAMES - 1}; max |T_est - T_gt| "
            f"{max_gt_err(seq, ar.total_transforms):.4e}; wall {time.perf_counter() - t0:.3f} s")
    return launches


# ------------------------------------------------------------ serving, scale-out


def sequence_batch(dev, yaws):
    """Sequences of ``N_FRAMES`` 640x480 frames with the given yaws,
    rendered on ``dev``: (sequences, ``OrganizedCloud`` [B, n, H, W, ...],
    the static accumulated-yaw guesses f32[B, n-1, 4, 4])."""
    import torch

    from rspc_tpu_torch.capture.synthetic import SyntheticSequence
    from rspc_tpu_torch.cloud import OrganizedCloud
    from rspc_tpu_torch.ops.deproject import Intrinsics

    seqs = [SyntheticSequence(n_frames=N_FRAMES, yaw_step=y,
                              intr=Intrinsics.simple(WIDTH, HEIGHT)) for y in yaws]
    clouds = [s.clouds(device=dev) for s in seqs]
    stacked = OrganizedCloud(**{k: torch.stack([torch.stack([getattr(c, k) for c in cs])
                                                for cs in clouds])
                                for k in ("xyz", "rgb", "valid")})
    guesses = []
    for y in yaws:  # benchmarks/serving.py's accumulation
        g, acc = [], 0.0
        for _ in range(N_FRAMES - 1):
            acc += y
            m = np.eye(4, dtype=np.float32)
            m[0, 0], m[0, 2], m[2, 0], m[2, 2] = np.cos(acc), np.sin(acc), -np.sin(acc), np.cos(acc)
            g.append(m)
        guesses.append(np.stack(g))
    return seqs, stacked, torch.from_numpy(np.stack(guesses)).to(dev)


def frames_of(stacked, i):
    """Sequence ``i`` of a [B, n, ...] batch as its list of frames."""
    return [stacked.map(lambda x, f=f: x[i, f]) for f in range(stacked.xyz.shape[1])]


def phase_serving(dev, card):
    """``batched_registration`` (no mesh) at B = 1, 2, 4 sequences of the
    north-star workload (benchmarks/serving.py: yaw -0.08 - 0.01 i,
    ``north_star_config()``, static guesses, no global cloud): each
    sequence's totals equal one ``_registration_fused`` run on it bit for
    bit and every pair converges; each sequence within 1e-3 of the truth,
    or ``record_gate`` of the JAX package's figure where it misses 1e-3
    (``SERVE_JAX_CPU``). Sequences/s is B
    over the min of 3 timed runs after the counted first. Returns the
    B = 4 run's launches."""
    import torch

    from rspc_tpu_torch.parallel import batched_registration
    from rspc_tpu_torch.presets import north_star_config
    from rspc_tpu_torch.registration.chainscan import _registration_fused

    config = north_star_config()
    seqs, stacked, guesses = sequence_batch(dev, [YAW_STEP - 0.01 * i
                                                  for i in range(max(SERVE_BATCHES))])
    singles = [_registration_fused(frames_of(stacked, i), guesses[i], config, True)["totals"]
               for i in range(len(seqs))]
    rows, launches = [], None
    for b in SERVE_BATCHES:
        sub, g = stacked.map(lambda x: x[:b]), guesses[:b]

        def run():
            out = batched_registration(sub, g, config, use_ndt=True, include_global=False)
            torch.cuda.synchronize()
            return out

        out, launches, plain = counted(run)
        if any(plain.values()) or launches["nn_sweep"] <= 0 or launches["hysteresis"] <= 0:
            raise AssertionError(f"serving B={b} kernels: {launches}, plain {plain}")
        errs, gates = [], []
        for i in range(b):
            if not torch.equal(out["totals"][i], singles[i]):
                raise AssertionError(f"serving B={b}: sequence {i}'s totals differ from "
                                     "its single run")
            errs.append(float(pair_errs(seqs[i], out["totals"][i]).max()))
            conv = int(out["converged"][i].sum())
            ref = SERVE_JAX_CPU[i]
            gate = MAX_ERR if ref < MAX_ERR else record_gate(MAX_ERR, ref)
            gates.append(gate)
            if conv != N_FRAMES - 1 or not errs[-1] < gate:
                raise AssertionError(f"serving B={b} sequence {i}: converged {conv}/"
                                     f"{N_FRAMES - 1}, max |T_est - T_gt| {errs[-1]:.3e} "
                                     f"(gate {gate})")
        times = []
        for _ in range(TIMED_RUNS):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        rows.append({"batch": b, "wall_s": min(times), "seq_per_s": b / min(times),
                     "runs_s": times, "max_err": errs, "gate": gates})
    log(f"serving (batched_registration, no mesh; {card}): {json.dumps(rows)}")
    log(f"serving launches (B={SERVE_BATCHES[-1]}, one run): {launches}")
    return launches


def phase_scaleout(dev, card):
    """The sharded paths on the card. NCCL at world size 1 in this
    process: ``points_sharded_registration`` of the north star equals
    ``_registration_fused`` bit for bit. Then two gloo ranks in their own
    processes, both on cuda:0 (``scaleout_rank``): sharded NN, ICP and
    NDT, the points-sharded chain and the data-sharded batch against
    their single-rank runs. Returns the sharded calls' launches."""
    import os
    import pickle
    import tempfile

    import torch
    import torch.distributed as dist

    from rspc_tpu_torch.parallel import make_mesh, points_sharded_registration
    from rspc_tpu_torch.presets import north_star_config
    from rspc_tpu_torch.registration.chainscan import _registration_fused

    config = north_star_config()
    seqs, stacked, guesses = sequence_batch(dev, [YAW_STEP])
    frames = frames_of(stacked, 0)
    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl", world_size=1, rank=0)
        try:
            mesh = make_mesh(1, axes=("points",))
            run = lambda: points_sharded_registration(
                stacked.map(lambda x: x[0]), guesses[0], config, mesh, include_global=False)
            (out, launches, plain), first_s = wall(lambda: counted(run))
            _, sharded_s = wall(run)
        finally:
            dist.destroy_process_group()
        single, single_s = wall(lambda: _registration_fused(frames, guesses[0], config, True))
        if not torch.equal(out["totals"], single["totals"]) or any(plain.values()):
            raise AssertionError("NCCL world size 1: the points-sharded chain differs from "
                                 f"the single-rank run (plain {plain})")
        log(f"scaleout NCCL world size 1: points_sharded_registration equals "
            f"_registration_fused bit for bit; walls: first {first_s:.4f} s, then "
            f"{sharded_s:.4f} s, the single-rank run {single_s:.4f} s; launches {launches}")

        log(f"scaleout gloo: {SCALE_RANKS} ranks on one card (cuda:0), gloo all-reduces of "
            "CUDA tensors: this shows the sharded paths on the card; its walls measure "
            "nothing about scale-out")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--scaleout-rank", str(r),
             f"{tmp}/gloo", tmp]) for r in range(SCALE_RANKS)]
        try:
            codes = [p.wait(timeout=SCALE_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if any(codes):
            raise AssertionError(f"scaleout gloo ranks exited with {codes}")
        res = []
        for r in range(SCALE_RANKS):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:  # our own ranks wrote these
                res.append(pickle.load(f))
    log(f"scaleout gloo: {time.perf_counter() - t0:.2f} s with the ranks' start; rank 0: "
        f"{json.dumps({k: v for k, v in res[0].items() if k != 'checks'})}")
    for r in range(1, SCALE_RANKS):
        if res[r]["checks"] != res[0]["checks"]:
            raise AssertionError(f"scaleout: rank {r}'s results differ from rank 0's")
    failed = [k for k, ok in res[0]["checks"].items() if not ok]
    if failed:
        raise AssertionError(f"scaleout gates failed: {failed}")
    total = {k: launches[k] + sum(x["launches"][k] for x in res) for k in launches}
    if total["nn_sweep"] <= 0 or total["hysteresis"] <= 0:
        raise AssertionError(f"scaleout kernels: {total}")
    return total


def scaleout_rank(rank: int, init_file: str, out_dir: str) -> None:
    """One of ``SCALE_RANKS`` gloo ranks on cuda:0 (``phase_scaleout``):
    each sharded call against its single-rank run on the same inputs;
    results, walls and the sharded calls' launches pickled to
    ``out_dir/rank{rank}.pkl``."""
    import pickle
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.cloud import Cloud
    from rspc_tpu_torch.config import ICPConfig, NDTConfig
    from rspc_tpu_torch.ops.nn import nearest_neighbors_cuda
    from rspc_tpu_torch.parallel import (
        batched_registration,
        make_mesh,
        points_sharded_registration,
        sharded_icp_align,
        sharded_ndt_align,
        sharded_nearest_neighbors,
    )
    from rspc_tpu_torch.presets import north_star_config
    from rspc_tpu_torch.registration.chainscan import _registration_fused
    from rspc_tpu_torch.registration.icp import icp_align
    from rspc_tpu_torch.registration.ndt import build_ndt_grid, ndt_align

    torch.cuda.set_device(0)
    dev = torch.device("cuda:0")
    cuda_build.library()  # the parent's build, found by its source hash
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=SCALE_RANKS, rank=rank,
                            timeout=timedelta(seconds=SCALE_TIMEOUT_S))
    launches = {k: 0 for k in cuda_build.LAUNCHES}
    walls, errs, checks = {}, {}, {}

    def sharded(name, fn):
        """fn's result; its wall and its launches counted as the path's."""
        torch.cuda.synchronize()
        cuda_build.reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        for k, v in cuda_build.LAUNCHES.items():
            launches[k] += v
        if any(cuda_build.PLAIN_ON_CUDA.values()):
            raise AssertionError(f"{name}: a plain version ran on CUDA tensors")
        return out

    try:
        mesh_p = make_mesh(SCALE_RANKS, axes=("points",))
        mesh_dp = make_mesh(SCALE_RANKS)
        mesh_d = make_mesh(SCALE_RANKS, axes=("data",))
        dims = lambda m: dict(zip(m.mesh_dim_names, m.mesh.shape))
        checks["meshes"] = (dims(mesh_p), dims(mesh_dp), dims(mesh_d)) == (
            {"points": 2}, {"data": 1, "points": 2}, {"data": 2})

        rng = np.random.default_rng(0)  # the main NN shape, live rows in every shard
        tgt = rng.uniform(-3.0, 3.0, (NN_TGT_CAP, 3)).astype(np.float32)
        tv = rng.random(NN_TGT_CAP) < 0.5
        src = (tgt[rng.integers(0, NN_TGT_CAP, NN_SRC)]
               + rng.normal(0, 0.01, (NN_SRC, 3))).astype(np.float32)
        sv = rng.random(NN_SRC) < 0.95
        args = [torch.from_numpy(a).to(dev) for a in (src, sv, tgt, tv)]
        d2, idx = sharded("nn", lambda: sharded_nearest_neighbors(*args, mesh_p))
        d2_1, idx_1 = nearest_neighbors_cuda(*args)
        checks["nn equals the unsharded B1 sweep"] = bool(
            torch.equal(d2, d2_1) and torch.equal(idx, idx_1))

        box = lambda n, seed: _box(n, seed, dev)
        tgt_c = Cloud(box(NN_TGT_CAP // 4, 1), torch.zeros(NN_TGT_CAP // 4, 3, device=dev),
                      torch.ones(NN_TGT_CAP // 4, dtype=torch.bool, device=dev))
        c, s = np.cos(0.02), np.sin(0.02)
        rot = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=torch.float32, device=dev)
        src_xyz = box(8192, 2) @ rot.T + torch.tensor([0.01, -0.005, 0.004], device=dev)
        src_c = Cloud(src_xyz, torch.zeros_like(src_xyz),
                      torch.ones(8192, dtype=torch.bool, device=dev))
        icp_cfg = ICPConfig(max_iterations=30, transformation_epsilon=1e-10,
                            euclidean_fitness_epsilon=1e-12, max_correspondence_distance=0.05)
        one = icp_align(src_c, tgt_c, icp_cfg).transform
        for name, mesh in (("icp points", mesh_p), ("icp data x points", mesh_dp)):
            got = sharded(name, lambda mesh=mesh: sharded_icp_align(src_c, tgt_c, mesh,
                                                                    icp_cfg).transform)
            errs[name] = float((got - one).abs().max())
            checks[f"{name} within {SCALE_TOL}"] = errs[name] <= SCALE_TOL

        wall = np.stack([rng.uniform(0, 3, 4096), rng.uniform(0, 2, 4096),
                         3.0 + rng.normal(0, 0.01, 4096)], axis=1).astype(np.float32)
        floor = wall.copy()
        floor[:, 1] = rng.normal(0, 0.01, 4096)
        floor[:, 2] = rng.uniform(0, 3, 4096)
        scene = torch.from_numpy(np.concatenate([wall, floor])).to(dev)
        full = lambda xyz: Cloud(xyz, torch.zeros_like(xyz),
                                 torch.ones(xyz.shape[0], dtype=torch.bool, device=dev))
        ndt_cfg = NDTConfig(dense_grid_dim=16, neighborhood=7, max_iterations=20)
        grid = build_ndt_grid(full(scene), ndt_cfg)
        ndt_src = full(scene[::2] + torch.tensor([0.04, 0.0, -0.03], device=dev))
        got = sharded("ndt", lambda: sharded_ndt_align(ndt_src, grid, mesh_p, ndt_cfg).transform)
        errs["ndt"] = float((got - ndt_align(ndt_src, grid, ndt_cfg).transform).abs().max())
        checks[f"ndt within {SCALE_TOL}"] = errs["ndt"] <= SCALE_TOL

        config = north_star_config()
        seqs, stacked, guesses = sequence_batch(dev, [YAW_STEP - 0.01 * i
                                                      for i in range(SCALE_RANKS)])
        out = sharded("points chain", lambda: points_sharded_registration(
            stacked.map(lambda x: x[0]), guesses[0], config, mesh_p, include_global=False))
        single = _registration_fused(frames_of(stacked, 0), guesses[0], config, True)["totals"]
        errs["points chain vs single"] = float((out["totals"] - single).abs().max())
        errs["points chain vs truth"] = float(pair_errs(seqs[0], out["totals"]).max())
        checks["points chain 9/9 converged"] = int(out["converged"].sum()) == N_FRAMES - 1
        checks[f"points chain within {MAX_ERR} of the truth"] = (
            errs["points chain vs truth"] < MAX_ERR)
        checks[f"points chain within {SCALE_CHAIN_TOL} of one rank"] = (
            errs["points chain vs single"] <= SCALE_CHAIN_TOL)

        got = sharded("data batch", lambda: batched_registration(
            stacked, guesses, config, mesh=mesh_d, include_global=False))
        want = batched_registration(stacked, guesses, config, include_global=False)
        checks["data-sharded batch equals the unsharded one"] = all(
            torch.equal(got[k], want[k]) for k in want)
        if "jax" in sys.modules or "rspc_tpu" in sys.modules:
            raise AssertionError("a scale-out rank imported jax or rspc_tpu")
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump({"checks": checks, "errs": errs, "walls_s": walls,
                     "launches": launches}, f)


def ndt_pair(dev, scheme):
    """The north star's first NDT pair: frame 1's edge cloud (voxel
    downsampled as the chain does) against the grid of frame 0's, with
    the static yaw guess."""
    from rspc_tpu_torch.ops.transform import static_y_guess
    from rspc_tpu_torch.ops.voxel import voxel_downsample

    voxel = scheme.config.voxel
    feats = scheme._out["features"]
    edges = [voxel_downsample(feats.map(lambda x, i=i: x[i]), voxel.leaf_size,
                              voxel.max_points) for i in (0, 1)]
    return edges[0], edges[1], static_y_guess(YAW_STEP).to(dev)


def phase_ndt_modes(dev, seq, clouds):
    """The north star with NDT's two optional modes, each run from counts
    set to 0: the PCL-exact line search (9/9 within ``MAX_ERR``, totals
    within ``NDT_EXACT_DELTA`` of the frozen line search's run in this
    call) and the compact-cell sweep at 512 cells (9/9, totals within
    ``NDT_SWEEP_TOL`` of the gather path's); then one ``ndt_align`` pair
    at the PCL default neighbourhood (27) with ``sweep_cells=-1`` (auto,
    512) against the gather path (``NDT_PAIR_TOL``), and the host syncs
    per Newton step of either line search on that pair."""
    import dataclasses

    import torch

    from rspc_tpu_torch.presets import north_star_config
    from rspc_tpu_torch.registration.ndt import build_ndt_grid, ndt_align
    from rspc_tpu_torch.registration.schemes import NDTEdgeBasedRegistration

    base = north_star_config()
    modes = {"frozen": base.ndt,
             "exact": dataclasses.replace(base.ndt, pcl_exact_line_search=True),
             "sweep": dataclasses.replace(base.ndt, sweep_cells=512)}
    runs, total = {}, None
    for name, ndt in modes.items():
        cfg = dataclasses.replace(base, ndt=ndt)

        def run(cfg=cfg):
            scheme = NDTEdgeBasedRegistration(rads=YAW_STEP, config=cfg)
            scheme.registration(clouds)
            torch.cuda.synchronize()
            return scheme

        run()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scheme, launches, plain = counted(run)
        wall = time.perf_counter() - t0
        _, syncs = count_syncs(run)
        errs = pair_errs(seq, scheme.total_transforms)
        conv = [bool(f.converged) for _, f in scheme.results]
        iters = [int(c.iterations) for c, _ in scheme.results]
        runs[name] = (scheme, errs)
        log(f"ndt_modes {name}: wall {wall:.4f} s, {syncs} host syncs; "
            f"converged {sum(conv)}/{len(conv)}; "
            f"max |T_est - T_gt| {errs.max():.3e}; NDT Newton iterations per pair {iters}; "
            f"launches {launches}; plain on CUDA {plain}")
        if not all(conv) or not errs.max() < MAX_ERR:
            raise AssertionError(f"ndt_modes {name}: converged {conv}, max err {errs.max():.3e}")
        if launches["nn_sweep"] <= 0 or launches["hysteresis"] <= 0 or any(plain.values()):
            raise AssertionError(f"ndt_modes {name} kernels: {launches}, plain {plain}")
        if name != "frozen":
            total = launches if total is None else {k: total[k] + launches[k] for k in total}
    frozen = runs["frozen"][0].total_transforms
    delta = {k: float((runs[k][0].total_transforms - frozen).abs().max())
             for k in ("exact", "sweep")}
    log(f"ndt_modes totals against the frozen gather run of this call: exact {delta['exact']:.3e} "
        f"(gate {NDT_EXACT_DELTA}), sweep {delta['sweep']:.3e} (gate {NDT_SWEEP_TOL})")
    if not (delta["exact"] <= NDT_EXACT_DELTA and delta["sweep"] <= NDT_SWEEP_TOL):
        raise AssertionError(f"ndt_modes deltas {delta}")

    tgt, src, guess = ndt_pair(dev, runs["frozen"][0])
    pair_cfg = dataclasses.replace(base.ndt, neighborhood=27)
    grid = build_ndt_grid(tgt, pair_cfg)
    # host syncs per Newton step: the pair started 10 cm off its guess,
    # solved to the end and to one step; the difference over the extra
    # steps leaves out the set-up's host-to-device copies
    off = guess.clone()
    off[:3, 3] += torch.tensor([0.1, 0.0, 0.05], device=dev)
    res = {}
    for name, cfg in (("gather", pair_cfg),
                      ("auto sweep", dataclasses.replace(pair_cfg, sweep_cells=-1)),
                      ("exact", dataclasses.replace(pair_cfg, pcl_exact_line_search=True))):
        ndt_align(src, grid, cfg, guess)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = ndt_align(src, grid, cfg, guess)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        full, s_full = count_syncs(lambda cfg=cfg: ndt_align(src, grid, cfg, off))
        _, s_one = count_syncs(lambda cfg=cfg: ndt_align(
            src, grid, dataclasses.replace(cfg, max_iterations=1), off))
        steps = int(full.iterations)
        per_step = (s_full - s_one) / (steps - 1) if steps > 1 else float("nan")
        log(f"ndt_modes pair (27 cells, {int(grid.valid.sum())} valid cells) {name}: "
            f"{ms:.2f} ms, {int(res[name].iterations)} Newton steps; from 10 cm off: "
            f"{steps} steps, {s_full} host syncs, {s_one} at one step: {per_step:.2f} "
            f"per Newton step")
    pair_err = float((res["auto sweep"].transform - res["gather"].transform).abs().max())
    log(f"ndt_modes pair: auto sweep against the gather path {pair_err:.3e} (gate {NDT_PAIR_TOL})")
    if not pair_err <= NDT_PAIR_TOL:
        raise AssertionError(f"ndt_modes pair: the sweep differs from the gather path {pair_err}")
    ndt_cube(dev)
    return total, runs["exact"][0].total_transforms


def cube_case():
    """(source, target) xyz of tests/test_parallel.py's NDT case."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 4, (1024, 3)).astype(np.float32)
    c, s = np.cos(0.05), np.sin(0.05)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return pts @ rot.T + np.float32([0.02, 0.0, -0.01]), pts


def ndt_cube(dev):
    """The cube case in each NDT mode on the card against the port's CPU
    run: iterations equal and transforms within ``CUBE_TOL`` (the sweep:
    iterations within one and ``CUBE_SWEEP_TOL``; see ``CUBE_MODES``)."""
    import torch

    from rspc_tpu_torch.cloud import Cloud
    from rspc_tpu_torch.config import NDTConfig
    from rspc_tpu_torch.registration.ndt import build_ndt_grid, ndt_align

    src_np, tgt_np = cube_case()
    for name, extra in CUBE_MODES.items():
        cfg = NDTConfig(dense_grid_dim=16, transformation_epsilon=1e-4, **extra)
        out = {}
        for where in (dev, torch.device("cpu")):
            src = Cloud.from_numpy(src_np, device=where)
            res = ndt_align(src, build_ndt_grid(Cloud.from_numpy(tgt_np, device=where), cfg), cfg)
            out[where.type] = (int(res.iterations), res.transform.cpu().numpy(), float(res.score))
        err = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
        log(f"ndt_modes cube {name}: card {out['cuda'][0]} Newton steps, score "
            f"{out['cuda'][2]:.6f}; CPU {out['cpu'][0]} steps, score {out['cpu'][2]:.6f}; "
            f"transforms {err:.3e} apart")
        steps = abs(out["cuda"][0] - out["cpu"][0])
        ok = (steps <= 1 and err <= CUBE_SWEEP_TOL) if name == "sweep" else (
            steps == 0 and err <= CUBE_TOL)
        if not ok:
            raise AssertionError(f"ndt_modes cube {name}: card {out['cuda'][:1]} against CPU "
                                 f"{out['cpu'][:1]}, {err:.3e} apart")


def phase_config1(dev, clouds):
    """BASELINE config 1: frames 0 and 1 flattened, ``voxel_downsample(c,
    0.02, 10240)`` as set-up, then the timed ``icp_align(down[1], down[0],
    ICPConfig(), static_y_guess(yaw))`` (as ``benchmarks/workloads.py``
    times it): the min wall of 3 after a warm-up, the host syncs, and
    one run of both from counts set to 0 that must launch B1 (and no
    plain version on the card); converged, with fitness and transform
    within ``CONFIG1_TOL`` of the port's CPU run of the same clouds."""
    import torch

    from rspc_tpu_torch.cloud import Cloud
    from rspc_tpu_torch.config import ICPConfig
    from rspc_tpu_torch.ops.transform import static_y_guess
    from rspc_tpu_torch.ops.voxel import voxel_downsample
    from rspc_tpu_torch.registration.icp import icp_align

    flat = [Cloud(c.xyz.reshape(-1, 3), c.rgb.reshape(-1, 3), c.valid.reshape(-1))
            for c in clouds[:2]]

    def align(down, where):
        res = icp_align(down[1], down[0], ICPConfig(), static_y_guess(YAW_STEP).to(where))
        if where.type == "cuda":
            torch.cuda.synchronize()
        return res

    def run(pair, where):
        down = [voxel_downsample(c, CONFIG1_LEAF, CONFIG1_CAP) for c in pair]
        return down, align(down, where)

    (down, res), launches, plain = counted(lambda: run(flat, dev))
    times = timed_runs("config1", lambda: align(down, dev))
    _, syncs = count_syncs(lambda: align(down, dev))
    cpu = torch.device("cpu")
    _, ref = run([c.map(lambda x: x.cpu()) for c in flat], cpu)
    t_err = float((res.transform.cpu() - ref.transform).abs().max())
    f_err = abs(float(res.fitness) - float(ref.fitness))
    shape = f"{down[1].capacity} x {down[0].capacity}"
    log(f"config1 min wall of icp_align {min(times):.4f} s, {syncs} host syncs; converged "
        f"{bool(res.converged)} in {int(res.iterations)} iterations, fitness "
        f"{float(res.fitness):.6e}; against the CPU run: transform {t_err:.3e}, fitness "
        f"{f_err:.3e} (CPU {int(ref.iterations)} iterations); B1 at {shape} "
        f"({int(down[1].valid.sum())} x {int(down[0].valid.sum())} valid): launches "
        f"{launches}; plain on CUDA {plain}")
    if not bool(res.converged) or t_err > CONFIG1_TOL or f_err > CONFIG1_TOL:
        raise AssertionError(f"config1: converged {bool(res.converged)}, transform {t_err:.3e}, "
                             f"fitness {f_err:.3e}")
    if launches["nn_sweep"] <= 0 or launches["nn_sweep_split"] != 0 or any(plain.values()):
        raise AssertionError(f"config1 kernels: {launches}, plain {plain}")
    return launches


def sor_oracle(xyz: np.ndarray, valid: np.ndarray, mean_k: int, stddev_mult: float):
    """(keep, mean distances, threshold) of StatisticalOutlierRemoval in
    float64 by a scipy kd-tree (``mean_k`` + 1 neighbours, self first)."""
    from scipy.spatial import cKDTree

    pts = xyz[valid].astype(np.float64)
    d, _ = cKDTree(pts).query(pts, k=mean_k + 1, workers=-1)
    md = np.full(len(xyz), np.nan)
    md[valid] = d[:, 1:].mean(axis=1)
    thresh = np.nanmean(md) + stddev_mult * np.nanstd(md)
    return valid & (md <= thresh), md, thresh


def normals_oracle(xyz: np.ndarray, valid: np.ndarray, radius: float):
    """(normals, valid, the degenerate neighbourhoods, covariances,
    smallest eigenvalues) of radius-search normal estimation in float64:
    scipy ``query_ball_point``, each point's neighbour covariance, its
    smallest eigenvector flipped toward the origin. Degenerate:
    neighbourhoods whose two smallest eigenvalues lie within
    ``NORMAL_GAP`` m^2 (points near a line), where f32 moments at metre
    coordinates (errors about 1e-7 m^2) leave the direction within the
    two smallest eigenvectors' plane undetermined."""
    from scipy.spatial import cKDTree

    pts = xyz.astype(np.float64)
    idx = np.flatnonzero(valid)
    lists = cKDTree(pts[idx]).query_ball_point(pts[idx], radius, workers=-1)
    counts = np.array([len(x) for x in lists])
    rows = np.repeat(np.arange(len(idx)), counts)
    nb = pts[idx][np.concatenate(lists)]
    n = np.maximum(counts, 1)[:, None]
    mu = np.stack([np.bincount(rows, nb[:, j], len(idx)) for j in range(3)], 1) / n
    d = nb - mu[rows]
    cov = np.stack([np.stack([np.bincount(rows, d[:, a] * d[:, b], len(idx))
                              for b in range(3)], -1) for a in range(3)], -2) / n[..., None]
    w, v = np.linalg.eigh(cov)
    nrm = v[..., 0]
    nrm = np.where(((nrm * pts[idx]).sum(-1) > 0)[:, None], -nrm, nrm)
    out = np.zeros((len(xyz), 3))
    out[idx] = nrm
    ok = np.zeros(len(xyz), bool)
    ok[idx] = counts >= 3
    degenerate = np.zeros(len(xyz), bool)
    degenerate[idx] = w[:, 1] - w[:, 0] < NORMAL_GAP
    cov_all = np.zeros((len(xyz), 3, 3))
    cov_all[idx] = cov
    w0 = np.zeros(len(xyz))
    w0[idx] = w[:, 0]
    return out, ok, degenerate, cov_all, w0


def phase_input_side(dev, card, seq, clouds, totals):
    """The input side on one rendered 640x480 frame: the two filters on
    its 307,200 slots against numpy / scipy oracles, radius normals at r
    = 0.05 and 0.1 on its voxel-downsampled cloud against a float64
    oracle, Brown-Conrady deprojection against the numpy forward model,
    the world-frame trajectory render of ``totals`` against the port's
    CPU render, and ``python -m rspc_tpu_torch.examples.pcd_visualization``
    on a PCD of that cloud. Every wall is the card's (synchronized)."""
    import os
    import tempfile

    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.io.pcd import save_pcd
    from rspc_tpu_torch.ops.deproject import Intrinsics, deproject_depth
    from rspc_tpu_torch.ops.filters import passthrough, statistical_outlier_removal
    from rspc_tpu_torch.ops.normals import estimate_normals_radius
    from rspc_tpu_torch.ops.voxel import voxel_downsample
    from rspc_tpu_torch.viz.trajectory import (
        DEPTH_TO_WORLD, render_trajectory, trajectory_from_transforms)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    walls = {}
    cuda_build.reset_counts()
    cloud = clouds[0].flatten()
    xyz, valid = cloud.xyz.cpu().numpy(), cloud.valid.cpu().numpy()
    kept, walls["passthrough"] = timed(lambda: passthrough(cloud, "z", 0.2, 2.5))
    want = valid & (xyz[:, 2] >= np.float32(0.2)) & (xyz[:, 2] <= np.float32(2.5))
    if not np.array_equal(kept.valid.cpu().numpy(), want):
        raise AssertionError("passthrough differs from its numpy mask")

    statistical_outlier_removal(cloud.map(lambda x: x[:4096]), mean_k=50)  # warm-up
    sor, walls["statistical_outlier_removal"] = timed(
        lambda: statistical_outlier_removal(cloud, mean_k=50, stddev_mult=1.5))
    keep_o, md, thresh = sor_oracle(xyz, valid, 50, 1.5)
    near = np.abs(md - thresh) <= 1e-6 * thresh
    differ = (sor.valid.cpu().numpy() != keep_o) & ~near
    log(f"input_side SOR (mean_k 50, 1.5 sigma) on {int(valid.sum())} of {len(valid)} slots: "
        f"kept {int(sor.valid.sum())}, the oracle {int(keep_o.sum())}; {int(near.sum())} within "
        f"1e-6 of the threshold {thresh:.6e}; {int(differ.sum())} others differ")
    if differ.any():
        raise AssertionError(f"SOR differs from the cKDTree oracle at {int(differ.sum())} points")

    down = voxel_downsample(cloud, 0.02, 65536)
    d_xyz, d_valid = down.xyz.cpu().numpy(), down.valid.cpu().numpy()
    for r in (0.05, 0.1):
        (nrm, ok), walls[f"normals r={r}"] = timed(lambda r=r: estimate_normals_radius(down, r))
        o_nrm, o_ok, degen, cov, w0 = normals_oracle(d_xyz, d_valid, r)
        ok = ok.cpu().numpy()
        n64 = nrm.cpu().numpy().astype(np.float64)
        cos = np.abs((n64 * o_nrm).sum(-1))
        # where the two smallest eigenvalues nearly meet, |cos| is not
        # determined; the normal must still lie in their plane: its
        # Rayleigh quotient on the float64 covariance at the smallest one
        rq = np.einsum("ni,nij,nj->n", n64, cov, n64) - w0
        gate, line = o_ok & ~degen, o_ok & degen
        line_cos = f"{cos[line].min():.6f}" if line.any() else "-"
        line_rq = f"{rq[line].max():.3e}" if line.any() else "-"
        log(f"input_side normals r={r} on {int(d_valid.sum())} points: valid {int(ok.sum())}, "
            f"the oracle {int(o_ok.sum())} (masks differ at {int((ok != o_ok).sum())}); "
            f"min |cos| {cos[gate].min():.6f} over {int(gate.sum())} points (gate 0.999); "
            f"{int(line.sum())} near-collinear neighbourhoods (eigenvalue gap < {NORMAL_GAP} m^2): "
            f"min |cos| {line_cos}, {int((cos[line] < 0.999).sum())} below 0.999, "
            f"max n^T C n - lambda_min {line_rq} m^2 (gate {NORMAL_RQ_TOL})")
        if ((ok != o_ok).any() or not cos[gate].min() >= 0.999
                or (line.any() and not rq[line].max() <= NORMAL_RQ_TOL)):
            raise AssertionError(f"radius normals r={r} differ from the float64 oracle")

    coeffs = (0.1, -0.05, 0.001, 0.001, 0.01)
    intr = Intrinsics.simple(WIDTH, HEIGHT)
    intr = Intrinsics(intr.width, intr.height, intr.fx, intr.fy, intr.ppx, intr.ppy, coeffs)
    depth = torch.full((HEIGHT, WIDTH), 1000, dtype=torch.int32, device=dev)
    pts, walls["deproject (distorted)"] = timed(lambda: deproject_depth(depth, intr))
    p = pts.cpu().numpy().astype(np.float64)
    xu, yu = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
    k1, k2, p1, p2, k3 = coeffs
    r2 = xu * xu + yu * yu
    f = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    u, v = np.meshgrid(np.arange(WIDTH), np.arange(HEIGHT))
    derr = max(np.abs(xu * f + 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
                      - (u - intr.ppx) / intr.fx).max(),
               np.abs(yu * f + 2 * p2 * xu * yu + p1 * (r2 + 2 * yu * yu)
                      - (v - intr.ppy) / intr.fy).max())
    log(f"input_side deproject_depth with Brown-Conrady {coeffs} at {WIDTH}x{HEIGHT}: the "
        f"numpy forward model gives back the pixel rays within {derr:.3e} (gate {UNDISTORT_TOL})")
    if not derr <= UNDISTORT_TOL:
        raise AssertionError(f"undistortion error {derr}")

    tot = totals.cpu().numpy()
    path = trajectory_from_transforms(tot) @ DEPTH_TO_WORLD[:3, :3].T
    frusta = [DEPTH_TO_WORLD @ m for m in tot]
    kw = dict(pose=DEPTH_TO_WORLD, frusta=frusta, width=WIDTH, height=HEIGHT)
    img, walls["render_trajectory"] = timed(lambda: render_trajectory(cloud, path, **kw))
    cpu_img = render_trajectory(cloud.map(lambda x: x.cpu()), path, **kw)
    differ = int((img != cpu_img).any(-1).sum())
    log(f"input_side render_trajectory {WIDTH}x{HEIGHT}: {differ} pixels differ from the CPU "
        f"render; {int((img != 153).any(-1).sum())} drawn")
    if differ > CLI_VIEW_TIE_FRAC * WIDTH * HEIGHT or not (img != 153).any():
        raise AssertionError(f"render_trajectory: {differ} pixels differ from the CPU render")

    with tempfile.TemporaryDirectory() as tmp:
        save_pcd(os.path.join(tmp, "frame0.pcd"), down, keep_invalid=False)
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rspc_tpu_torch.examples.pcd_visualization", "frame0.pcd"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        walls["pcd_visualization (process)"] = time.perf_counter() - t0
        png = os.path.join(tmp, "frame0.pcd.view.png")
        drawn = int((read_png(png) != 153).any(-1).sum()) if os.path.exists(png) else 0
        log(f"input_side pcd_visualization: rc {proc.returncode}; "
            f"{proc.stdout.strip()!r}; PNG pixels drawn {drawn}")
        if proc.returncode != 0 or drawn == 0:
            raise AssertionError(f"pcd_visualization failed: {proc.stderr[-2000:]}")
    launches, plain = dict(cuda_build.LAUNCHES), dict(cuda_build.PLAIN_ON_CUDA)
    if any(plain.values()):
        raise AssertionError(f"input_side: plain versions on CUDA tensors {plain}")
    log(f"input_side walls on {card} (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in walls.items()))
    return launches


def phase_feature_quality(dev, card):
    """The port's feature-quality harness (``rspc_tpu_torch/tools/
    feature_quality.py``) on the card: frame 0 of its synthetic pair
    rendered on the card, the four warps of ``homographies`` through
    ``warp_perspective``, each at ratios 0.3 and 0.7 with the default
    options, and ``FQ_OPTIONS``' rows at ratio 0.3. Every row runs twice
    on the card (the features and matches equal bit for bit) and once on
    the CPU (the row within ``FQ_*_TOL``); the default rows at ratio 0.3
    meet ``FQ_FLOORS``; then ``python -m
    rspc_tpu_torch.tools.feature_quality`` as a process. No kernel runs
    here: the JAX code it ports reaches no ``pl.pallas_call``."""
    import os

    import torch

    from rspc_tpu_torch import cuda_build
    from rspc_tpu_torch.tools import feature_quality as fq

    cuda_build.reset_counts()
    ga = fq.test_images(device=dev)[0]
    hs = fq.homographies(ga.shape[1], ga.shape[0])
    warped = {name: fq.warp_perspective(ga, h) for name, h in hs.items()}
    fq.match_pair(ga, warped["shift"], device=dev)  # warm-up
    runs = [(name, r, {}) for name in hs for r in FQ_RATIOS] + [
        (name, 0.3, opts) for name, opts in FQ_OPTIONS]
    walls = {"card": 0.0, "cpu": 0.0}
    failed = []
    for name, ratio, opts in runs:
        got = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got.append(fq.match_pair(ga, warped[name], ratio, device=dev, **opts))
            torch.cuda.synchronize()
            walls["card"] += time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(*got))
        row = fq._stats(*(t.cpu().numpy() for t in got[0]), hs[name], 3.0, ga.shape)
        t0 = time.perf_counter()
        cpu = fq.measure_ours(ga, warped[name], hs[name], ratio=ratio, device="cpu", **opts)
        walls["cpu"] += time.perf_counter() - t0
        what = f"{name} ratio {ratio}" + "".join(f" {k}={v}" for k, v in opts.items())
        fmt = lambda r: (f"kp {r['kp_a']}/{r['kp_b']}, repeatability {r['repeatability']:.4f}, "
                         f"matches {r['n_matches']}, inlier rate {r['inlier_rate']:.4f}")
        log(f"feature_quality {what}: card {fmt(row)}; cpu {fmt(cpu)}; two card runs "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            failed.append(f"{what}: two card runs differ")
        for key, tol in (("repeatability", FQ_REP_TOL), ("n_matches", FQ_MATCH_TOL),
                         ("inlier_rate", FQ_INLIER_TOL)):
            a, b = row[key], cpu[key]
            if not (abs(a - b) <= tol or (np.isnan(a) and np.isnan(b))):
                failed.append(f"{what}: {key} {a} on the card, {b} on the CPU (allowance {tol})")
        if ratio == 0.3 and not opts:
            rep, matches, inliers = FQ_FLOORS[name]
            if ((rep is not None and row["repeatability"] < rep) or row["n_matches"] < matches
                    or not row["inlier_rate"] >= inliers):
                failed.append(f"{what}: {row} under the floors {FQ_FLOORS[name]}")

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "rspc_tpu_torch.tools.feature_quality"],
                          env=env, capture_output=True, text=True, timeout=300)
    walls["python -m rspc_tpu_torch.tools.feature_quality (process)"] = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    log("feature_quality python -m rspc_tpu_torch.tools.feature_quality: rc "
        f"{proc.returncode}\n" + proc.stdout.rstrip())
    if proc.returncode != 0 or len(lines) != 1 + len(hs) * len(FQ_RATIOS):
        failed.append(f"python -m rspc_tpu_torch.tools.feature_quality: {proc.stderr[-2000:]}")
    launches, plain = dict(cuda_build.LAUNCHES), dict(cuda_build.PLAIN_ON_CUDA)
    if any(launches.values()) or any(plain.values()):
        failed.append(f"kernel launches {launches}, plain versions on CUDA tensors {plain}")
    log(f"feature_quality walls on {card} (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in walls.items()))
    if failed:
        raise AssertionError("feature_quality: " + "; ".join(failed))
    return launches


def _box(n: int, seed: int, dev):
    """``n`` points on the faces of a unit box 2 m ahead."""
    import torch

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    pts[np.arange(n), axis] = rng.integers(0, 2, n) - 0.5
    pts[:, 2] += 2.0
    return torch.from_numpy(pts).to(dev)


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
    from rspc_tpu_torch.presets import robust_config
    from rspc_tpu_torch.registration import schemes
    from rspc_tpu_torch.registration.auto import auto_register
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

        # the robust stack on the command line: --registration under the
        # robust preset, --all under auto, each against its API run
        launches = command(["--registration", "seq", str(CLI_DEG), str(CLI_FRAMES),
                            "--preset", "robust"], profile=True)
        back = load_pcd(os.path.join(ds, "seq-registration"), device="cpu")
        api = schemes.NDTEdgeBasedRegistration(
            rads=rads, config=robust_config(anchor_mode="map")).registration(
            load_dataset_clouds("seq", CLI_FRAMES, "dataset", device=dev))
        want = api.xyz[api.valid].cpu()
        rob_err = float((back.xyz - want).abs().max()) if back.xyz.shape == want.shape else None
        log(f"cli --registration --preset robust: {back.xyz.shape[0]} points read back, the "
            f"API run {want.shape[0]}; max |diff| {rob_err}")
        if rob_err is None or not rob_err <= CLI_REG_TOL:
            raise AssertionError(f"--registration --preset robust differs from the API run: "
                                 f"{rob_err}")
        if launches["nn_sweep"] <= 0 or launches["hysteresis"] <= 0:
            raise AssertionError(f"--registration --preset robust kernels: {launches}")
        launches = command(["--all", str(CLI_FRAMES), "out", "--preset", "auto"], profile=True)
        back = load_pcd(os.path.join(ds, "out.pcd"), device="cpu")
        ar = auto_register(clouds, thetas=thetas)
        want = ar.global_cloud.xyz[ar.global_cloud.valid].cpu()
        auto_err = float((back.xyz - want).abs().max()) if back.xyz.shape == want.shape else None
        log(f"cli --all --preset auto: the API run selects {ar.selected} (escalated "
            f"{ar.escalated}, scores {ar.scores}); out.pcd {back.xyz.shape[0]} points read "
            f"back, the API run {want.shape[0]}; max |diff| {auto_err}")
        if auto_err is None or not auto_err <= CLI_ALL_TOL:
            raise AssertionError(f"--all --preset auto differs from the API run: {auto_err}")
        if launches["nn_sweep"] <= 0 or launches["hysteresis"] <= 0:
            raise AssertionError(f"--all --preset auto kernels: {launches}")
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

    walls = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t, 1)
        return out

    hyst = timed("B3", phase_hysteresis, dev, clouds)
    per_path = {"north star": timed("north star", phase_slice, dev, seq, clouds),
                "incremental": timed("incremental", phase_incremental, dev, seq, clouds)}
    per_path["config 2"], hc = timed("config 2", phase_edges5, dev, clouds)
    per_path["config1"] = timed("config1", phase_config1, dev, clouds)
    ref_clouds, ref_thetas = replay_capture(seq, dev)
    per_path["config 3"] = timed("config 3", phase_icp_edge, dev, seq, clouds, ref_thetas)
    per_path["reference preset"] = timed("reference preset", phase_reference, dev, seq,
                                         ref_clouds, ref_thetas)
    per_path["cli"] = timed("cli", phase_cli, dev, card)
    per_path["robust"], robust_nn = timed("robust", phase_robust, dev)
    per_path["auto"] = timed("auto", phase_auto, dev, card)
    per_path["serving"] = timed("serving", phase_serving, dev, card)
    per_path["scaleout"] = timed("scaleout", phase_scaleout, dev, card)
    per_path["ndt_modes"], exact_totals = timed("ndt_modes", phase_ndt_modes, dev, seq, clouds)
    per_path["input_side"] = timed("input_side", phase_input_side, dev, card, seq, clouds,
                                   exact_totals)
    per_path["feature_quality"] = timed("feature_quality", phase_feature_quality, dev, card)
    log(f"phase walls (s): {walls}")
    log(f"launches per path (each from counts set to 0): {per_path}")
    nn["max_abs_err"] = max(nn["max_abs_err"], *(v["err"] for v in robust_nn.values()))
    for shape, v in robust_nn.items():
        nn.update({f"{k}_{shape}_shape": v[k] for k in ("ms", "plain_ms", "library_ms",
                                                         "bound_ms")})
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
    if sys.argv[1:2] == ["--scaleout-rank"]:
        scaleout_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main())
