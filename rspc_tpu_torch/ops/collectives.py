"""Reductions over an optional process group: the port's counterpart of
the JAX package's ``lax.psum`` / ``lax.pmax`` over a named mesh axis.

A solver takes ``group=None`` (one rank: nothing is reduced, the values
pass through untouched) or a ``torch.distributed`` process group (a mesh
dimension's, ``DeviceMesh.get_group(axis)``) over whose ranks its source
points are sharded. Only ``all_reduce`` is used (SUM, MAX, MIN), so the
same code runs on NCCL and on gloo with CUDA tensors (gloo reduces CUDA
tensors with ``broadcast`` and ``all_reduce`` only). Nothing here
catches a collective's failure or moves a tensor to another device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def shard_count(group) -> int:
    """Ranks of ``group`` (1 for no group)."""
    return 1 if group is None else dist.get_world_size(group)


def shard_index(group) -> int:
    """This rank's index in ``group`` (0 for no group)."""
    return 0 if group is None else dist.get_rank(group)


def psum(tensors, group):
    """``tensors`` (a tuple of tensors of one dtype) summed elementwise
    over ``group``'s ranks in ONE ``all_reduce``; unchanged for no group."""
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return tuple(out)


def _reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    if group is None:
        return t
    t = t.clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum over ``group``'s ranks."""
    return _reduce(t, group, dist.ReduceOp.MAX)


def pmin(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise minimum over ``group``'s ranks."""
    return _reduce(t, group, dist.ReduceOp.MIN)


def shard_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous chunk of ``x``'s rows, ``x`` padded with
    zero rows (False for masks: invalid points) to a multiple of the
    group's size, so every rank holds the same row count."""
    n = shard_count(group)
    chunk = -(-x.shape[0] // n)
    pad = n * chunk - x.shape[0]
    if pad:
        x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))
    i = shard_index(group)
    return x[i * chunk:(i + 1) * chunk]


def shard_cloud(c, group):
    """This rank's contiguous chunk of a replicated cloud's rows, padded
    with invalid rows (``shard_rows`` on every field;
    ``rspc_tpu/registration/chainscan.py::_shard_points``): a solve then
    sweeps only its chunk and all-reduces the additive moments."""
    return c.map(lambda x: shard_rows(x, group))


def gather_rows(x: torch.Tensor, total: int, group) -> torch.Tensor:
    """Every rank's ``x`` (``k = total / ranks`` rows, rank ``i``'s rows
    ``i*k``) in one ``[total, ...]`` tensor on every rank: each rank
    writes its rows into a zero-filled buffer and one SUM all-reduce adds
    them, exact because exactly one rank contributes each entry (masks
    travel as int32). Unchanged for no group."""
    if group is None:
        return x
    k = x.shape[0]
    buf = torch.zeros((total, *x.shape[1:]),
                      dtype=torch.int32 if x.dtype == torch.bool else x.dtype,
                      device=x.device)
    i = shard_index(group)
    buf[i * k:(i + 1) * k] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(x.dtype)
