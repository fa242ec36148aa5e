"""Target-sharded nearest-neighbour search (port of
``rspc_tpu/parallel/nn.py``).

Every rank holds the whole source and target; each sweeps its contiguous
``1/D`` of the target rows with the port's NN (``ops/nn.py::nn_scores``:
kernel B1 on the card) and the ranks combine their winners with two MIN
all-reduces: the best score, then the lowest global index among the
ranks that hold it. Each shard is recentred on the whole target's
centroid, so every (source, target) pair scores exactly as in the
unsharded sweep, and the combine is the unsharded sweep's own rule
(lowest score, then lowest index): the result equals the unsharded
sweep's, distances and indices. The JAX package combines with an
``all_gather`` and an ``argmin`` of the re-scored distances; gloo
reduces CUDA tensors with ``all_reduce`` alone.
"""

from __future__ import annotations

import torch

from rspc_tpu_torch.ops.collectives import pmin, shard_count, shard_index
from rspc_tpu_torch.ops.nn import PENALTY_WINS, _rescore, nn_scores, target_centroid


def sharded_nearest_neighbors(src_xyz, src_valid, tgt_xyz, tgt_valid, mesh,
                              axis: str = "points", chunk: int = 2048):
    """``ops/nn.py::nn_sweep``'s contract, ``(dist2 f32[N], idx i32[N])``,
    with the target's rows sharded over the mesh axis ``axis`` (their
    count must divide by its size); every rank passes the whole inputs
    and gets the whole result."""
    group = mesh.get_group(axis)
    d = shard_count(group)
    m = tgt_xyz.shape[0]
    if m % d:
        raise ValueError(f"target rows {m} not divisible by the '{axis}' axis size {d}")
    shard = m // d
    base = shard_index(group) * shard
    rows = slice(base, base + shard)
    score, idx = nn_scores(src_xyz, src_valid, tgt_xyz[rows], tgt_valid[rows],
                           min(chunk, shard), target_centroid(tgt_xyz, tgt_valid))
    best = pmin(score, group)
    mine = torch.where(score == best, idx + base, torch.iinfo(torch.int32).max)
    win = pmin(mine.to(torch.int32), group)
    return _rescore(src_xyz, src_valid, tgt_xyz, tgt_valid, best, win, best < PENALTY_WINS)
