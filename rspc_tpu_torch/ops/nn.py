"""Nearest-neighbour correspondence search (port of ``rspc_tpu/ops/nn.py``
and ``rspc_tpu/ops/nn_pallas.py``).

Contract (every version): for each source point, the index of and
squared distance to its nearest valid target point; ``(dist2 f32[N],
idx i32[N])``, with ``dist2 = inf`` for invalid sources and for an empty
target. All recentre on the valid-target centroid (invalid rows zeroed
before the sum: padding slots may hold arbitrary bytes), score with
``|t|^2 - 2 s.t`` (the ``|s|^2`` term cannot change the argmin), and
re-score each winner exactly as ``|s - t_win|^2``.

  * :func:`nearest_neighbors` -- the plain PyTorch chunked sweep (lowest
    index within a chunk, strict ``<`` across chunks);
  * :func:`nearest_neighbors_cuda` -- kernel B1 (``csrc/nn_sweep.cu``);
  * :func:`nearest_neighbors_stream_cuda` -- kernel B2
    (``csrc/nn_sweep_split.cu``), the live target split across blocks;
  * :func:`nn_sweep` -- the dispatch: CUDA tensors launch kernel B2 when
    the static target capacity, padded up to a multiple of
    ``TGT_CHUNK``, exceeds ``STREAM_TARGET`` (:func:`streams`, the JAX
    wrapper's ``MAX_VMEM_TARGET`` rule), else kernel B1; CPU tensors take
    the plain sweep. There is no fallback between them.

Indices of a kernel and the plain sweep may differ only at exact
distance ties (``ops/nn_check.py``'s contract); B1 and B2 agree bit for
bit.
"""

from __future__ import annotations

import torch

from rspc_tpu_torch import cuda_build

# big-but-finite penalty for invalid target rows, and the winner check
# that rejects it (rspc_tpu/ops/nn_pallas.py keeps the same pair)
PENALTY = 1e30
PENALTY_WINS = 1e29

# Routing between the two kernels by static target capacity, the
# counterpart of rspc_tpu/ops/nn_pallas.py's MAX_VMEM_TARGET and
# TGT_CHUNK: a capacity that, padded up to a multiple of TGT_CHUNK,
# exceeds STREAM_TARGET takes kernel B2. Shapes alone decide, so routing
# never syncs with the host.
STREAM_TARGET = 2_500_000
TGT_CHUNK = 1024

# kernel B2's sources per block (csrc/nn_sweep_split.cu: 128 threads x 2
# sources), the blocks per SM its split count aims at, and the split cap
SPLIT_SRC_TILE = 256
SPLIT_BLOCKS_PER_SM = 8
MAX_SPLITS = 64


def _recentre(src_xyz, tgt_xyz, tgt_valid):
    txyz = torch.where(tgt_valid[:, None], tgt_xyz, 0.0)
    wsum = tgt_valid.sum(dtype=txyz.dtype)
    centroid = txyz.sum(dim=0) / torch.clamp(wsum, min=1.0)
    return src_xyz - centroid, txyz - centroid


def _rescore(src_xyz, src_valid, tgt_xyz, tgt_valid, best_score, best_idx, ok):
    t_win = tgt_xyz.index_select(0, best_idx.long())
    diff = src_xyz - t_win
    dist2 = (diff * diff).sum(dim=-1)
    ok = ok & src_valid & torch.isfinite(best_score) & tgt_valid.any()
    return torch.where(ok, dist2, float("inf")), best_idx


def nearest_neighbors(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk: int = 2048):
    """Plain PyTorch sweep: the target in ``chunk``-row tiles holding a
    running (best score, best index); peak memory one [N, chunk] tile."""
    if src_xyz.is_cuda:
        cuda_build.PLAIN_ON_CUDA["nn_sweep"] += 1
    n, m = src_xyz.shape[0], tgt_xyz.shape[0]
    s, t = _recentre(src_xyz, tgt_xyz, tgt_valid)
    best_score = torch.full((n,), float("inf"), device=s.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=s.device)
    for base in range(0, m, chunk):
        tc = t[base:base + chunk]
        score = (tc * tc).sum(dim=-1)[None, :] - 2.0 * (s @ tc.T)
        score = torch.where(tgt_valid[None, base:base + chunk], score, float("inf"))
        c_score, c_idx = score.min(dim=1)
        upd = c_score < best_score
        best_score = torch.where(upd, c_score, best_score)
        best_idx = torch.where(upd, (base + c_idx).to(torch.int32), best_idx)
    return _rescore(src_xyz, src_valid, tgt_xyz, tgt_valid, best_score,
                    best_idx, torch.ones_like(src_valid))


def _pack(src_xyz, src_valid, tgt_xyz, tgt_valid):
    """The kernels' shared pre-processing: check the inputs, recentre on
    the valid-target centroid, pack the target as float4 (x, y, z,
    |t|^2 + penalty) with the 1e30 penalty on invalid rows and the
    sources as float4 (x, y, z, 0), and reduce the live bound (highest
    valid index + 1) on the device, so nothing syncs with the host."""
    # the kernels read only the packed copies made here, so the inputs
    # need not be contiguous
    src_xyz, src_valid, tgt_xyz, tgt_valid = (
        x.contiguous() for x in (src_xyz, src_valid, tgt_xyz, tgt_valid))
    n, m = src_xyz.shape[0], tgt_xyz.shape[0]
    for name, x in (("src_xyz", src_xyz), ("tgt_xyz", tgt_xyz)):
        cuda_build.require_cuda(name, x, torch.float32)
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"nn sweep: {name} must be [N, 3], got {tuple(x.shape)}")
    cuda_build.require_cuda("src_valid", src_valid, torch.bool, (n,))
    cuda_build.require_cuda("tgt_valid", tgt_valid, torch.bool, (m,))
    if m == 0:
        raise ValueError("nn sweep: the target has no rows")
    s, t = _recentre(src_xyz, tgt_xyz, tgt_valid)
    norm_pen = (t * t).sum(dim=-1) + torch.where(tgt_valid, 0.0, PENALTY)
    tgt4 = torch.cat([t, norm_pen[:, None]], dim=1).contiguous()
    src4 = torch.nn.functional.pad(s, (0, 1)).contiguous()
    ramp = torch.arange(1, m + 1, dtype=torch.int32, device=t.device)
    live_hi = torch.where(tgt_valid, ramp, 0).amax().reshape(1).contiguous()
    best_score = torch.empty((n,), dtype=torch.float32, device=s.device)
    best_idx = torch.empty((n,), dtype=torch.int32, device=s.device)
    return src4, tgt4, live_hi, best_score, best_idx


def nearest_neighbors_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid):
    """Kernel B1 (``csrc/nn_sweep.cu``), replacing the TPU kernel
    ``rspc_tpu/ops/nn_pallas.py::_nn_kernel`` with its wrapper's
    pre- and post-processing kept as they were.

    Pre (:func:`_pack`): recentre on the valid-target centroid; pack the
    target as (x, y, z, |t|^2 + penalty) with the 1e30 penalty on invalid
    rows; the live bound (highest valid index + 1) is reduced on the
    device and the kernel reads it from device memory, so nothing syncs
    with the host.
    Post: exact re-score of each winner; a winner whose score is not
    below 1e29 (only penalised rows) or a source with no valid target
    reports inf.

    What bounds it on the card: FP32 instruction throughput, 4 FMA-class
    operations per (source, live target) pair, one thread per source with
    the target staged through shared memory (see the kernel's header)."""
    src4, tgt4, live_hi, best_score, best_idx = _pack(
        src_xyz, src_valid, tgt_xyz, tgt_valid)
    n = src4.shape[0]
    if n:
        code = cuda_build.library().rspc_nn_sweep(
            src4.data_ptr(), tgt4.data_ptr(), live_hi.data_ptr(), n,
            best_score.data_ptr(), best_idx.data_ptr(),
            cuda_build.stream_of(src4),
        )
        cuda_build.check(code, "rspc_nn_sweep")
        cuda_build.LAUNCHES["nn_sweep"] += 1
    return _rescore(src_xyz, src_valid, tgt_xyz, tgt_valid, best_score,
                    best_idx, best_score < PENALTY_WINS)


def split_count(n: int) -> int:
    """Target splits of kernel B2 for ``n`` sources: enough (source tile,
    split) blocks for ``SPLIT_BLOCKS_PER_SM`` per SM, at most
    ``MAX_SPLITS``. Static: the source count and the card alone decide."""
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    tiles = -(-n // SPLIT_SRC_TILE)
    return max(1, min(MAX_SPLITS, -(-SPLIT_BLOCKS_PER_SM * sms // tiles)))


def nearest_neighbors_stream_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid):
    """Kernel B2 (``csrc/nn_sweep_split.cu``), replacing the TPU kernel
    ``rspc_tpu/ops/nn_pallas.py::_nn_kernel_hbm`` (the route for targets
    above ``STREAM_TARGET``), with B1's wrapper contract bit for bit:
    the same :func:`_pack` pre-processing, the same ``< 1e29`` winner
    check and exact re-score, inf for an invalid source or an empty
    target.

    Pass 1 runs on a grid of (source tiles x :func:`split_count` target
    splits); each block sweeps its even share of the live prefix and
    writes a partial (score, index) into a ``[splits, n]`` scratch
    allocated here. Pass 2 takes per source the lexicographic minimum
    over splits (smaller score, then the lower split), which keeps the
    plain sweep's lowest-index tie rule. Bounded, like B1, by FP32
    instruction throughput (4 FMA-class operations per pair)."""
    src4, tgt4, live_hi, best_score, best_idx = _pack(
        src_xyz, src_valid, tgt_xyz, tgt_valid)
    n = src4.shape[0]
    if n:
        splits = split_count(n)
        part_score = torch.empty((splits, n), dtype=torch.float32, device=src4.device)
        part_idx = torch.empty((splits, n), dtype=torch.int32, device=src4.device)
        code = cuda_build.library().rspc_nn_sweep_split(
            src4.data_ptr(), tgt4.data_ptr(), live_hi.data_ptr(), n, splits,
            part_score.data_ptr(), part_idx.data_ptr(),
            best_score.data_ptr(), best_idx.data_ptr(),
            cuda_build.stream_of(src4),
        )
        cuda_build.check(code, "rspc_nn_sweep_split")
        cuda_build.LAUNCHES["nn_sweep_split"] += 1
    return _rescore(src_xyz, src_valid, tgt_xyz, tgt_valid, best_score,
                    best_idx, best_score < PENALTY_WINS)


def streams(m: int) -> bool:
    """True when a target of static capacity ``m`` takes kernel B2: its
    capacity padded up to a multiple of ``TGT_CHUNK`` exceeds
    ``STREAM_TARGET`` (read at call time, so a caller may move it)."""
    return m + (-m) % TGT_CHUNK > STREAM_TARGET


def nn_sweep(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk: int = 2048):
    """Device dispatch: for CUDA tensors kernel B2 where :func:`streams`
    holds for the target's capacity, else kernel B1; the plain sweep for
    CPU tensors. ``chunk`` only shapes the plain sweep's tiles."""
    if src_xyz.is_cuda:
        if streams(tgt_xyz.shape[0]):
            return nearest_neighbors_stream_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid)
        return nearest_neighbors_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid)
    return nearest_neighbors(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk)
