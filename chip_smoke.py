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
  5. the benchmark workload: 10 synthetic 640x480 frames, yaw -0.08 rad per
     frame, rendered on the card, through
     ``NDTEdgeBasedRegistration(rads=-0.08, config=north_star_config())``:
     one warm-up and timed runs; the launch counts of one registration
     show that it went through both kernels; every pair must converge and
     max |T_est - T_gt| must stay below 1e-3.

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
    log(f"B1 main shape {NN_SRC} x {NN_TGT_CAP} (live {NN_TGT_LIVE}): "
        f"max |dist2 kernel - plain| {err:.3e}; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")

    # the anchor's flattened sweep: 9 frames x 3,414 strided points vs 10,240
    a_src = torch.from_numpy(rng.uniform(-2, 2, (9 * 3414, 3)).astype(np.float32)).to(dev)
    a_sv = torch.ones(9 * 3414, dtype=torch.bool, device=dev)
    a_tgt = torch.from_numpy(rng.uniform(-2, 2, (10240, 3)).astype(np.float32)).to(dev)
    a_tv = torch.ones(10240, dtype=torch.bool, device=dev)
    a_ms = cuda_ms(lambda: nearest_neighbors_cuda(a_src, a_sv, a_tgt, a_tv), 20)
    a_plain = cuda_ms(lambda: nearest_neighbors(a_src, a_sv, a_tgt, a_tv, 2048), 5)
    log(f"B1 anchor shape {9 * 3414} x 10240: kernel {a_ms:.3f} ms, plain {a_plain:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    log(f"B3 {len(clouds)} x {HEIGHT}x{WIDTH}: bit-exact vs plain "
        f"({int(want.sum())} edge pixels; random masks too); kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


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
    if min(launches.values()) <= 0 or any(plain.values()):
        raise AssertionError(f"kernels not on the path: {launches}, plain {plain}")
    if not np.isfinite(result.xyz.cpu().numpy()).all():
        raise AssertionError("non-finite global cloud")
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

    if "jax" in sys.modules or "rspc_tpu" in sys.modules:
        raise AssertionError("the port imported jax or rspc_tpu")
    kernels = [
        {"name": "nn_sweep", "route": "cuda",
         "source": "rspc_tpu_torch/csrc/nn_sweep.cu",
         "replaces": "rspc_tpu/ops/nn_pallas.py:48",
         "launches": launches["nn_sweep"], **nn},
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
