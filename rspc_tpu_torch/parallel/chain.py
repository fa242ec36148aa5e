"""Sequence-batched and points-sharded registration (port of
``rspc_tpu/parallel/chain.py``).

``batched_registration`` registers ``B`` independent sequences of one
shape: each through the one-sequence program
(``registration/chainscan.py::_registration_fused``: phase 1, the frame
chain, the anchor or pose graph, the global cloud), one after another
as the JAX package's ``lax.map`` runs them (it does not ``vmap`` the
batch; its docstring says why). With a mesh, the batch is sharded over
its ``data`` axis: each rank registers its ``B / D`` sequences with no
collective inside, and one SUM all-reduce of zero-filled buffers gives
every rank the whole result.

``points_sharded_registration`` is one sequence with every pair solve
(coarse NDT or ICP, fine ICP) sharded over the ``points`` axis and its
moments all-reduced; the guard, rescue, refine, merges, anchor and pose
graph stay replicated, so the result equals one rank's up to the order
of the sums.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from rspc_tpu_torch.cloud import OrganizedCloud
from rspc_tpu_torch.config import PipelineConfig
from rspc_tpu_torch.ops.collectives import gather_rows, shard_count, shard_index
from rspc_tpu_torch.registration.chainscan import _registration_fused, _stack


def _one_seq(seq: OrganizedCloud, guesses, config: PipelineConfig, use_ndt: bool,
             include_global: bool, group=None) -> Dict[str, Any]:
    """One ``[n, H, W, ...]`` sequence through ``_registration_fused``,
    slimmed to what the batch returns."""
    n = seq.xyz.shape[0]
    frames = [seq.map(lambda x, i=i: x[i]) for i in range(n)]
    out = _registration_fused(frames, guesses, config, use_ndt, group)
    accepted = out["anchor_accepted"]
    if accepted is None:  # anchor disabled
        accepted = torch.zeros((n - 1,), dtype=torch.bool, device=seq.device)
    slim = {
        "totals": out["totals"],
        "converged": torch.stack([f.converged for f in out["fine"]]),
        "fitness": torch.stack([f.fitness for f in out["fine"]]),
        "anchor_accepted": accepted,
    }
    if include_global:
        slim["global"] = out["global"]
    return slim


def points_sharded_registration(stacked: OrganizedCloud, guesses: torch.Tensor,
                                config: PipelineConfig, mesh, use_ndt: bool = True,
                                axis: str = "points",
                                include_global: bool = True) -> Dict[str, Any]:
    """ONE sequence's registration with every pair solve sharded over the
    mesh axis ``axis``: ``stacked`` is ``[n, H, W, ...]`` and ``guesses``
    ``f32[n-1, 4, 4]``, both whole on every rank; returns what
    :func:`batched_registration` returns, without the batch axis, on
    every rank."""
    if stacked.xyz.dim() != 4:
        raise ValueError(
            f"stacked must be a single [n, H, W, 3] sequence; got xyz shape "
            f"{tuple(stacked.xyz.shape)}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh needs a '{axis}' axis; has {mesh.mesh_dim_names}")
    return _one_seq(stacked, guesses, config, use_ndt, include_global,
                    mesh.get_group(axis))


def batched_registration(stacked: OrganizedCloud, guesses: torch.Tensor,
                         config: PipelineConfig, use_ndt: bool = True,
                         mesh: Optional[Any] = None,
                         include_global: bool = True) -> Dict[str, Any]:
    """Register ``B`` independent sequences.

    Args:
      stacked: ``OrganizedCloud`` with leaves ``[B, n, H, W, ...]`` (one
        frame count and resolution for every sequence).
      guesses: ``f32[B, n-1, 4, 4]`` initial transforms per pair (IMU or
        the static accumulated rotation, as the schemes build them).
      config: the pipeline configuration, applied to each sequence as in
        the single-sequence path.
      use_ndt: the NDT coarse stage (``NDTEdgeBasedRegistration``) if
        True, else coarse ICP (``ICPEdgeBasedRegistration``).
      mesh: optional ``DeviceMesh`` with a ``"data"`` axis; the batch is
        sharded over it (B must divide by its size). Without one, every
        sequence runs here.
      include_global: also return the per-sequence global clouds.

    Returns a dict on every rank: ``totals`` f32[B, n-1, 4, 4]
    (frame -> frame-0 transforms), ``converged`` bool[B, n-1] (fine ICP),
    ``fitness`` f32[B, n-1] (NaN without ``icp.compute_fitness``),
    ``anchor_accepted`` bool[B, n-1] (all False without the anchor) and,
    with ``include_global``, ``global`` (a ``Cloud`` of ``[B, n*H*W]``).
    """
    if stacked.xyz.dim() != 5:
        raise ValueError(
            f"stacked must be a [B, n, H, W, 3] sequence batch; got xyz shape "
            f"{tuple(stacked.xyz.shape)}")
    b, n = stacked.xyz.shape[:2]
    if tuple(guesses.shape[:2]) != (b, n - 1):
        raise ValueError(
            f"guesses must be [B={b}, n-1={n - 1}, 4, 4]; got {tuple(guesses.shape)}")
    group = None
    if mesh is not None:
        if "data" not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh needs a 'data' axis; has {mesh.mesh_dim_names}")
        group = mesh.get_group("data")
        if b % shard_count(group):
            raise ValueError(f"batch {b} not divisible by data axis {shard_count(group)}")
    k = b // shard_count(group)
    start = shard_index(group) * k
    outs = [_one_seq(stacked.map(lambda x, i=i: x[i]), guesses[i], config, use_ndt,
                     include_global) for i in range(start, start + k)]
    result = {key: gather_rows(torch.stack([o[key] for o in outs]), b, group)
              for key in ("totals", "converged", "fitness", "anchor_accepted")}
    if include_global:
        result["global"] = _stack([o["global"] for o in outs]).map(
            lambda x: gather_rows(x, b, group))
    return result
