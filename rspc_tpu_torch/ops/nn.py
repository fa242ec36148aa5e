"""Nearest-neighbour correspondence search (port of ``rspc_tpu/ops/nn.py``
and ``rspc_tpu/ops/nn_pallas.py``).

Contract (both versions): for each source point, the index of and
squared distance to its nearest valid target point; ``(dist2 f32[N],
idx i32[N])``, with ``dist2 = inf`` for invalid sources and for an empty
target. Both recentre on the valid-target centroid (invalid rows zeroed
before the sum: padding slots may hold arbitrary bytes), score with
``|t|^2 - 2 s.t`` (the ``|s|^2`` term cannot change the argmin), and
re-score each winner exactly as ``|s - t_win|^2``.

  * :func:`nearest_neighbors` -- the plain PyTorch chunked sweep (lowest
    index within a chunk, strict ``<`` across chunks);
  * :func:`nearest_neighbors_cuda` -- kernel B1 (``csrc/nn_sweep.cu``);
  * :func:`nn_sweep` -- the dispatch: CUDA tensors launch kernel B1, CPU
    tensors take the plain sweep. There is no fallback between the two.

Indices of the two versions may differ only at exact distance ties
(``ops/nn_check.py``'s contract).
"""

from __future__ import annotations

import torch

from rspc_tpu_torch import cuda_build

# big-but-finite penalty for invalid target rows, and the winner check
# that rejects it (rspc_tpu/ops/nn_pallas.py keeps the same pair)
PENALTY = 1e30
PENALTY_WINS = 1e29


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


def nearest_neighbors_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid):
    """Kernel B1 (``csrc/nn_sweep.cu``), replacing the TPU kernel
    ``rspc_tpu/ops/nn_pallas.py::_nn_kernel`` with its wrapper's
    pre- and post-processing kept as they were.

    Pre: recentre on the valid-target centroid; pack the target as
    (x, y, z, |t|^2 + penalty) with the 1e30 penalty on invalid rows; the
    live bound (highest valid index + 1) is reduced on the device and the
    kernel reads it from device memory, so nothing syncs with the host.
    Post: exact re-score of each winner; a winner whose score is not
    below 1e29 (only penalised rows) or a source with no valid target
    reports inf.

    What bounds it on the card: FP32 instruction throughput, 4 FMA-class
    operations per (source, live target) pair, one thread per source with
    the target staged through shared memory (see the kernel's header)."""
    # the kernel reads only the packed copies made below, so the inputs
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
    if n:
        code = cuda_build.library().rspc_nn_sweep(
            src4.data_ptr(), tgt4.data_ptr(), live_hi.data_ptr(), n,
            best_score.data_ptr(), best_idx.data_ptr(),
            cuda_build.stream_of(s),
        )
        cuda_build.check(code, "rspc_nn_sweep")
        cuda_build.LAUNCHES["nn_sweep"] += 1
    return _rescore(src_xyz, src_valid, tgt_xyz, tgt_valid, best_score,
                    best_idx, best_score < PENALTY_WINS)


def nn_sweep(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk: int = 2048):
    """Device dispatch: kernel B1 for CUDA tensors, the plain sweep for
    CPU tensors. ``chunk`` only shapes the plain sweep's tiles."""
    if src_xyz.is_cuda:
        return nearest_neighbors_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid)
    return nearest_neighbors(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk)
