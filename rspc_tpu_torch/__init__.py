"""rspc_tpu_torch -- the PyTorch + CUDA port of ``rspc_tpu``.

Same module paths and public names as the JAX package (``rspc_tpu``
stays in the repository as the reference every port test is held
against), rebuilt on PyTorch for one NVIDIA H100:

  cloud.py          -- fixed-capacity ``Cloud`` / ``OrganizedCloud`` tensors
  config.py         -- copy of the JAX package's typed configuration
  interop.py        -- numpy <-> port conversions the parity tests use
  ops/              -- transforms, image ops, Canny (kernel B3), normals,
                       edges, voxel grid, NN sweep (kernel B1), rigid fits,
                       keypoints (``first_octave``, ``sigma=None``, the
                       scale gate) and RANSAC, the filters
  registration/     -- ICP, NDT, anchor refinement, the fused chain,
                       ``NDTEdgeBasedRegistration``
  parallel/         -- serving and scale-out on ``torch.distributed``:
                       the sequence batch, the points-sharded chain,
                       sharded NN, ICP and NDT over a ``DeviceMesh``
  capture/          -- the synthetic RGBD renderer, replay, the v2
                       capture with its visual odometry
  io/               -- PCD files, the dataset directory, the native codec
  viz/              -- the headless renderer, PNG, the terminal viewer,
                       the world-frame trajectory renderer, overlays
  examples/         -- the standalone viewers (``python -m``)
  tools/            -- ``python -m rspc_tpu_torch.tools.feature_quality``:
                       the odometry's features on known warps
  utils/            -- logging, stage timers, profiler traces
  cli.py            -- the reference's ``rs-pcl`` command line
  cuda_build.py     -- builds ``csrc/*.cu`` with nvcc on first use and
                       binds it with ctypes
  csrc/             -- the hand-written Hopper kernels

A kernel wrapper launches its CUDA kernel for a CUDA tensor and takes
its plain PyTorch version only for a CPU tensor; nothing falls back.

The package imports neither jax nor ``rspc_tpu``. Functions take their
device from their input tensors (entry points that create tensors take
an explicit ``device``); there is no global default device.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry at millimetre scales cannot tolerate reduced-precision
# matmuls: the JAX package forces f32 for the same reason (bf16 cost it
# 2.5x end-to-end accuracy), and TF32's 10-bit mantissa is the same
# hazard on the card.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud  # noqa: E402,F401
from rspc_tpu_torch.config import (  # noqa: E402,F401
    EdgeConfig,
    ICPConfig,
    NDTConfig,
    PipelineConfig,
    VoxelConfig,
)
