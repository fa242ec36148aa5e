"""Source-sharded NDT (port of ``rspc_tpu/parallel/ndt.py``): the grid
and the guess replicated, the source's rows sharded over a mesh axis;
the score, gradient and Hessian are additive over source points, so
each evaluation ends in one all-reduce of at most 43 scalars and every
rank runs the same Newton steps and line searches
(``registration/ndt.py``, ``group``). The result lands on the same
optimum as one rank's; the sums add in another order, so an iteration
count may differ by one, as in the JAX package."""

from __future__ import annotations

import dataclasses

import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.config import NDTConfig
from rspc_tpu_torch.registration.ndt import NDTGrid, NDTResult, ndt_align


def sharded_ndt_align(src: Cloud, grid: NDTGrid, mesh, config: NDTConfig = NDTConfig(),
                      init_guess: torch.Tensor | None = None,
                      axis: str = "points") -> NDTResult:
    """Align ``src`` (every rank passes the whole cloud; each solves on
    its chunk of the rows) onto the replicated ``grid``. As in the JAX
    package, every source row takes part: ``max_source_points`` does not
    apply here (slice ``src`` first for a prefix)."""
    guess = (torch.eye(4, dtype=src.xyz.dtype, device=src.device) if init_guess is None
             else init_guess.to(src.xyz.dtype))
    return ndt_align(src, grid, dataclasses.replace(config, max_source_points=0), guess,
                     group=mesh.get_group(axis))
