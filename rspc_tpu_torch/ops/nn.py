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
  * :func:`nearest_neighbors_cuda` and :func:`nearest_neighbors_stream_cuda`
    -- the routes of the TPU kernels B1 (``_nn_kernel``) and B2
    (``_nn_kernel_hbm``): one CUDA kernel (``csrc/nn_sweep.cu``), the
    live target split across a grid that fills the card, launched by
    :func:`_sweep_cuda` on :func:`plan`; the routes share the kernel and
    the plan, and count their launches apart;
  * :func:`nn_sweep` -- the dispatch: CUDA tensors take B2's route when
    the static target capacity, padded up to a multiple of
    ``TGT_CHUNK``, exceeds ``STREAM_TARGET`` (:func:`streams`, the JAX
    wrapper's ``MAX_VMEM_TARGET`` rule), else B1's; CPU tensors take the
    plain sweep. There is no fallback between them.

Indices of the kernel and the plain sweep may differ only at exact
distance ties (``ops/nn_check.py``'s contract); the kernel gives the
same result bit for bit on every plan, so the two routes agree bit for
bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from rspc_tpu_torch import cuda_build

# big-but-finite penalty for invalid target rows, and the winner check
# that rejects it (rspc_tpu/ops/nn_pallas.py keeps the same pair)
PENALTY = 1e30
PENALTY_WINS = 1e29

# Routing between the two routes by static target capacity, the
# counterpart of rspc_tpu/ops/nn_pallas.py's MAX_VMEM_TARGET and
# TGT_CHUNK: a capacity that, padded up to a multiple of TGT_CHUNK,
# exceeds STREAM_TARGET takes B2's route. Shapes alone decide, so routing
# never syncs with the host.
STREAM_TARGET = 2_500_000
TGT_CHUNK = 1024

# the kernel's sources per block (csrc/nn_sweep.cu kSrcTile: 128 threads
# x 6 sources), and the split cap (it bounds the [splits, n] scratch)
SRC_TILE = 768
MAX_SPLITS = 1024


class SweepPlan(NamedTuple):
    """A launch of the NN sweep: ``tiles`` source tiles of ``SRC_TILE``
    x ``splits`` target splits, one block of pass 1 each."""

    tiles: int
    splits: int


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
    running (best score, best index); peak memory one [N, chunk] tile.
    Tiles after the last valid target row are skipped (they score inf
    everywhere and cannot win), as the kernels skip dead capacity."""
    if src_xyz.is_cuda:
        cuda_build.PLAIN_ON_CUDA["nn_sweep"] += 1
    n = src_xyz.shape[0]
    rows = tgt_valid.nonzero()
    live = int(rows[-1, 0]) + 1 if rows.numel() else 0
    s, t = _recentre(src_xyz, tgt_xyz, tgt_valid)
    best_score = torch.full((n,), float("inf"), device=s.device)
    best_idx = torch.zeros((n,), dtype=torch.int32, device=s.device)
    for base in range(0, live, chunk):
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


def plan(n: int, sms: int, resident: int) -> SweepPlan:
    """The NN sweep's launch plan for ``n`` sources on a card of ``sms``
    SMs that holds ``resident`` blocks of the sweep per SM: as many target
    splits as the ``sms * resident`` resident slots hold with one block
    per (source tile, split), at least 1 and at most ``MAX_SPLITS``. So
    the grid is one wave that leaves fewer than ``tiles`` slots idle
    (where there are more tiles than slots, one split runs in waves).
    Static: the source count and the card alone decide (never the live
    prefix, which only the device knows)."""
    tiles = -(-n // SRC_TILE)
    return SweepPlan(tiles, max(1, min(MAX_SPLITS, sms * resident // tiles)))


def share_bounds(live: int, splits: int) -> list[tuple[int, int]]:
    """The kernel's target share of each split, ``[(lo, hi), ...]``:
    even, contiguous and ascending, covering ``[0, live)``."""
    share = -(-live // splits)
    out = []
    for split in range(splits):
        lo = min(live, split * share)
        out.append((lo, min(live, lo + share)))
    return out


@functools.lru_cache(maxsize=None)
def _card_slots(device_index: int) -> tuple[int, int]:
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms, cuda_build.nn_sweep_resident()


def card_plan(n: int, device) -> SweepPlan:
    """:func:`plan` for this card (its SM count and the kernel's resident
    blocks per SM, queried once)."""
    return plan(n, *_card_slots(torch.device(device).index or 0))


def _launch(src4, tgt4, live_hi, best_score, best_idx, p: SweepPlan) -> None:
    """The kernel of ``csrc/nn_sweep.cu`` (both passes) on :func:`_pack`'s
    outputs and plan ``p``, with its ``[splits, n]`` scratch allocated
    here. Counts no launch: the wrappers do."""
    n = src4.shape[0]
    part_score = torch.empty((p.splits, n), dtype=torch.float32, device=src4.device)
    part_idx = torch.empty((p.splits, n), dtype=torch.int32, device=src4.device)
    code = cuda_build.library().rspc_nn_sweep(
        src4.data_ptr(), tgt4.data_ptr(), live_hi.data_ptr(), n, p.splits,
        part_score.data_ptr(), part_idx.data_ptr(), best_score.data_ptr(),
        best_idx.data_ptr(), cuda_build.stream_of(src4),
    )
    cuda_build.check(code, "rspc_nn_sweep")


def _sweep_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid, route: str):
    """Both routes' launch: :func:`_pack`, :func:`_launch` on
    :func:`card_plan`, then :func:`_rescore` with the ``< 1e29`` winner
    check. ``route`` names the launch count."""
    packed = _pack(src_xyz, src_valid, tgt_xyz, tgt_valid)
    n = packed[0].shape[0]
    if n:
        _launch(*packed, card_plan(n, packed[0].device))
        cuda_build.LAUNCHES[route] += 1
    best_score, best_idx = packed[3:]
    return _rescore(src_xyz, src_valid, tgt_xyz, tgt_valid, best_score,
                    best_idx, best_score < PENALTY_WINS)


def nearest_neighbors_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid):
    """The route of TPU kernel B1, ``rspc_tpu/ops/nn_pallas.py::_nn_kernel``
    (targets up to ``STREAM_TARGET``): the kernel of ``csrc/nn_sweep.cu``
    with the TPU wrapper's pre- and post-processing kept as they were, on
    :func:`card_plan`.

    Pre (:func:`_pack`): recentre on the valid-target centroid; pack the
    target as (x, y, z, |t|^2 + penalty) with the 1e30 penalty on invalid
    rows; the live bound (highest valid index + 1) is reduced on the
    device and the kernel reads it from device memory, so nothing syncs
    with the host.
    Post: exact re-score of each winner; a winner whose score is not
    below 1e29 (only penalised rows) or a source with no valid target
    reports inf.

    What bounds it on the card: FP32 issue, 4 FMA-class operations per
    (source, live target) pair plus the running minimum (see the
    kernel's header)."""
    return _sweep_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid, "nn_sweep")


def nearest_neighbors_stream_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid):
    """The route of TPU kernel B2, ``rspc_tpu/ops/nn_pallas.py::_nn_kernel_hbm``
    (targets above ``STREAM_TARGET``): the same kernel, plan and contract
    as :func:`nearest_neighbors_cuda`, counted apart."""
    return _sweep_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid, "nn_sweep_split")


def streams(m: int) -> bool:
    """True when a target of static capacity ``m`` takes B2's route: its
    capacity padded up to a multiple of ``TGT_CHUNK`` exceeds
    ``STREAM_TARGET`` (read at call time, so a caller may move it)."""
    return m + (-m) % TGT_CHUNK > STREAM_TARGET


def nn_sweep(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk: int = 2048):
    """Device dispatch: for CUDA tensors B2's route where :func:`streams`
    holds for the target's capacity, else B1's; the plain sweep for CPU
    tensors. ``chunk`` only shapes the plain sweep's tiles."""
    if src_xyz.is_cuda:
        if streams(tgt_xyz.shape[0]):
            return nearest_neighbors_stream_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid)
        return nearest_neighbors_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid)
    return nearest_neighbors(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk)
