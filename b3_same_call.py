#!/usr/bin/env python3
"""Kernel B3 against an earlier B3 kernel on the same card, in one call.

Usage (from the repository root, on a machine with a CUDA card):

    git show 8a9bed0:rspc_tpu_torch/csrc/hysteresis.cu > _chipcheck/old_hysteresis.cu
    python3 b3_same_call.py _chipcheck/old_hysteresis.cu

The earlier source is the one-CTA-per-frame kernel of commit 8a9bed0
(C entry ``rspc_hysteresis(strong, weak, out, frames, h, w, stream)``);
it is built with nvcc into ``rspc_tpu_torch/_build/`` beside the current
kernels. Both run on the masks of 10 rendered 640x480 frames, of 10
rendered 1280x720 frames (the largest the earlier kernel's shared memory
holds) and on a 10 x 480 x 640 percolation batch (p_weak 0.6); their
outputs must agree bit for bit, and each is timed in turns (earlier,
current, current, earlier) with ``chip_smoke.device_ms``. The last line
of standard output is one JSON object of the times in milliseconds.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from rspc_tpu_torch import cuda_build
from rspc_tpu_torch.ops.canny import hysteresis_cuda

REPS = 50


def build_earlier(src: Path):
    """Build the earlier kernel's source into its own library and bind
    its C entry."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = cuda_build.BUILD_DIR / "libearlier_b3.so"
    cmd = [cuda_build._nvcc(), *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", str(lib), str(src)]
    subprocess.run(cmd, check=True)
    cdll = ctypes.CDLL(str(lib))
    fn = cdll.rspc_hysteresis
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, i, i, i, vp]
    fn.restype = ctypes.c_int

    def earlier(strong, weak):
        out = torch.empty_like(strong)
        frames, h, w = strong.shape
        cuda_build.check(fn(strong.data_ptr(), weak.data_ptr(), out.data_ptr(), frames, h, w,
                            cuda_build.stream_of(strong)), "earlier rspc_hysteresis")
        return out

    return earlier


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage (on a CUDA card): b3_same_call.py EARLIER_HYSTERESIS_CU", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda:0")
    earlier = build_earlier(Path(sys.argv[1]))
    _, clouds = chip_smoke.render(dev, chip_smoke.WIDTH, chip_smoke.HEIGHT)
    _, hd = chip_smoke.render(dev, 1280, 720)
    inputs = {
        "rendered_10x480x640": chip_smoke.edge_masks(clouds),
        "rendered_10x720x1280": chip_smoke.edge_masks(hd),
        "percolation_10x480x640": chip_smoke.percolation_batch(dev),
    }
    del clouds, hd
    times = {}
    for name, (strong, weak) in inputs.items():
        a, b = earlier(strong, weak), hysteresis_cuda(strong, weak)
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {int((a != b).sum())} pixels differ")
        runs = [chip_smoke.device_ms(lambda f=f: f(strong, weak), REPS)
                for f in (earlier, hysteresis_cuda, hysteresis_cuda, earlier)]
        times[name] = {"earlier": [runs[0], runs[3]], "current": [runs[1], runs[2]]}
        print(f"{name}: equal bit for bit; earlier, current, current, earlier: "
              + ", ".join(f"{t:.4f}" for t in runs) + " ms", flush=True)
    print(json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
