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
    (``_nn_kernel_hbm``): one CUDA kernel (``csrc/nn_sweep.cu``) that
    plans its grid on the device over the live source prefix and splits
    the live target across the card's resident slots (:func:`plan`
    mirrors it), launched by :func:`_sweep_cuda`; the routes share the
    kernel and the plan, and count their launches apart;
  * :func:`nn_sweep` -- the dispatch: CUDA tensors take B2's route when
    the static target capacity, padded up to a multiple of
    ``TGT_CHUNK``, exceeds ``STREAM_TARGET`` (:func:`streams`, the JAX
    wrapper's ``MAX_VMEM_TARGET`` rule), else B1's; CPU tensors take the
    plain sweep. There is no fallback between them;
  * :func:`nn_scores` -- the same dispatch stopped before the re-score:
    each source's winning score and index, recentred on a centroid the
    caller may give. The target-sharded sweep (``parallel/nn.py``) runs
    it on each shard with the whole target's centroid, so every (source,
    target) pair scores as in the unsharded sweep.

Indices of the kernel and the plain sweep may differ only at exact
distance ties (``ops/nn_check.py``'s contract); the kernel gives the
same result bit for bit on every plan, so the two routes agree bit for
bit.
"""

from __future__ import annotations

import functools
import struct
from typing import NamedTuple

import torch

from rspc_tpu_torch import cuda_build
from rspc_tpu_torch.utils import profiling

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
# x 6 sources), and the split cap
SRC_TILE = 768
MAX_SPLITS = 1024
# the split cap handed to each launch (read at call time): a test lowers
# it to force a split count on the device's plan
SPLIT_CAP = MAX_SPLITS
# the kernel's key of a source no split wrote (a row past the live bound)
KEY_SENTINEL = 2**64 - 1


class SweepPlan(NamedTuple):
    """The NN sweep's plan: ``blocks`` launched, of which the first
    ``tiles x splits`` each sweep one (source tile of ``SRC_TILE``,
    target split) item and the rest exit at once."""

    blocks: int
    tiles: int
    splits: int


def _zeroed(tgt_xyz, tgt_valid):
    """The target with invalid rows zeroed (padding slots may hold
    arbitrary bytes)."""
    return torch.where(tgt_valid[:, None], tgt_xyz, 0.0)


def _centroid(txyz, tgt_valid):
    return txyz.sum(dim=0) / torch.clamp(tgt_valid.sum(dtype=txyz.dtype), min=1.0)


def target_centroid(tgt_xyz, tgt_valid):
    """The valid target rows' centroid, which the sweeps recentre on."""
    return _centroid(_zeroed(tgt_xyz, tgt_valid), tgt_valid)


def _recentre(src_xyz, tgt_xyz, tgt_valid, centroid=None):
    txyz = _zeroed(tgt_xyz, tgt_valid)
    if centroid is None:
        centroid = _centroid(txyz, tgt_valid)
    return src_xyz - centroid, txyz - centroid


def _rescore(src_xyz, src_valid, tgt_xyz, tgt_valid, best_score, best_idx, ok):
    t_win = tgt_xyz.index_select(0, best_idx.long())
    diff = src_xyz - t_win
    dist2 = (diff * diff).sum(dim=-1)
    ok = ok & src_valid & torch.isfinite(best_score) & tgt_valid.any()
    return torch.where(ok, dist2, float("inf")), best_idx


def _plain_scores(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk: int, centroid=None):
    """The plain sweep's (best score, best index) per source, before the
    re-score (an invalid source: score inf, index 0). Traces the sweep
    as the kernels' launch does; counts the valid source rows it sweeps
    (``nn.source_rows``)."""
    if src_xyz.is_cuda:
        cuda_build.PLAIN_ON_CUDA["nn_sweep"] += 1
    with profiling.span("nn.sweep", route="plain", sources=src_xyz.shape[0],
                        targets=tgt_xyz.shape[0]):
        return _plain_sweep(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk, centroid)


def _plain_sweep(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk: int, centroid):
    n = src_xyz.shape[0]
    rows = tgt_valid.nonzero()
    live = int(rows[-1, 0]) + 1 if rows.numel() else 0
    s, t = _recentre(src_xyz, tgt_xyz, tgt_valid, centroid)
    keep = src_valid.nonzero()[:, 0]
    profiling.count("nn.source_rows", keep.shape[0])
    s = s.index_select(0, keep)
    best_score = torch.full((keep.shape[0],), float("inf"), device=s.device)
    best_idx = torch.zeros((keep.shape[0],), dtype=torch.int32, device=s.device)
    for base in range(0, live, chunk):
        tc = t[base:base + chunk]
        score = (tc * tc).sum(dim=-1)[None, :] - 2.0 * (s @ tc.T)
        score = torch.where(tgt_valid[None, base:base + chunk], score, float("inf"))
        c_score, c_idx = score.min(dim=1)
        upd = c_score < best_score
        best_score = torch.where(upd, c_score, best_score)
        best_idx = torch.where(upd, (base + c_idx).to(torch.int32), best_idx)
    all_score = torch.full((n,), float("inf"), device=s.device).index_copy(0, keep, best_score)
    all_idx = torch.zeros((n,), dtype=torch.int32, device=s.device).index_copy(0, keep, best_idx)
    return all_score, all_idx


def nearest_neighbors(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk: int = 2048):
    """Plain PyTorch sweep: the target in ``chunk``-row tiles holding a
    running (best score, best index); peak memory one [N, chunk] tile.
    Tiles after the last valid target row are skipped (they score inf
    everywhere and cannot win), as the kernels skip dead capacity, and
    so are invalid sources (their distance is inf, their index 0)."""
    all_score, all_idx = _plain_scores(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk)
    return _rescore(src_xyz, src_valid, tgt_xyz, tgt_valid, all_score,
                    all_idx, torch.ones_like(src_valid))


def _pack(src_xyz, src_valid, tgt_xyz, tgt_valid, centroid=None):
    """The kernels' shared pre-processing: check the inputs, recentre on
    the valid-target centroid (or ``centroid``), pack the target as
    float4 (x, y, z, |t|^2 + penalty) with the 1e30 penalty on invalid
    rows and the sources as float4 (x, y, z, 0), and reduce the two live
    bounds (highest valid index + 1) on the device, ``src_live`` of the
    sources and ``live_hi`` of the target, so nothing syncs with the
    host."""
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
    s, t = _recentre(src_xyz, tgt_xyz, tgt_valid, centroid)
    norm_pen = (t * t).sum(dim=-1) + torch.where(tgt_valid, 0.0, PENALTY)
    tgt4 = torch.cat([t, norm_pen[:, None]], dim=1).contiguous()
    src4 = torch.nn.functional.pad(s, (0, 1)).contiguous()
    ramp = torch.arange(1, max(n, m) + 1, dtype=torch.int32, device=t.device)
    live_hi = torch.where(tgt_valid, ramp[:m], 0).amax().reshape(1)
    src_live = (torch.where(src_valid, ramp[:n], 0).amax().reshape(1) if n
                else torch.zeros(1, dtype=torch.int32, device=t.device))
    best_score = torch.empty((n,), dtype=torch.float32, device=s.device)
    best_idx = torch.empty((n,), dtype=torch.int32, device=s.device)
    return src4, tgt4, src_live, live_hi, best_score, best_idx


def plan(n: int, sms: int, resident: int, src_live: int | None = None,
         cap: int = MAX_SPLITS) -> SweepPlan:
    """The NN sweep's plan for ``n`` source rows whose valid rows end
    before ``src_live`` (default ``n``), on a card of ``sms`` SMs that
    holds ``resident`` blocks of the sweep per SM: the mirror of the plan
    each block of the kernel makes on the device. The host launches
    ``max(slots, tiles(n))`` blocks, ``slots = sms * resident``; the live
    tiles ``ceil(src_live / SRC_TILE)`` each take as many target splits
    as the slots hold, at least 1 and at most ``cap``, block ``b`` taking
    tile ``b % tiles`` and split ``b // tiles``; the blocks past ``tiles
    x splits`` exit. So the items fill one wave of the slots but for
    fewer than ``tiles`` of them (where the live tiles outnumber the
    slots, one split runs in waves). With ``src_live == n`` the plan is
    the one the host made before the plan moved to the device."""
    slots = sms * resident
    live = n if src_live is None else src_live
    tiles = -(-live // SRC_TILE)
    return SweepPlan(max(slots, -(-n // SRC_TILE)), tiles,
                     max(1, min(cap, slots // max(tiles, 1))))


def share_bounds(live: int, splits: int) -> list[tuple[int, int]]:
    """The kernel's target share of each split, ``[(lo, hi), ...]``:
    even, contiguous and ascending, covering ``[0, live)``."""
    share = -(-live // splits)
    out = []
    for split in range(splits):
        lo = min(live, split * share)
        out.append((lo, min(live, lo + share)))
    return out


def pack_key(score: float, idx: int) -> int:
    """The kernel's key of a source's (score, index) (``csrc/nn_sweep.cu``
    ``pack_key``): the f32 score's bits made order-preserving, -0.0 as
    +0.0, above the index, so that the keys' unsigned order is the
    lexicographic order of (score, index) that combines the splits."""
    b = struct.unpack("<I", struct.pack("<f", score))[0]
    if b == 0x8000_0000:
        b = 0
    b = (~b & 0xFFFF_FFFF) if b & 0x8000_0000 else b | 0x8000_0000
    return (b << 32) | (idx & 0xFFFF_FFFF)


def unpack_key(key: int) -> tuple[float, int]:
    """The kernel's pass 2: a key back to (score, index); the sentinel
    ``KEY_SENTINEL`` (no split wrote the row) gives (+inf, 0)."""
    if key == KEY_SENTINEL:
        return float("inf"), 0
    b = key >> 32
    b = b & 0x7FFF_FFFF if b & 0x8000_0000 else ~b & 0xFFFF_FFFF
    return struct.unpack("<f", struct.pack("<I", b))[0], key & 0xFFFF_FFFF


@functools.lru_cache(maxsize=None)
def _card_slots(device_index: int) -> tuple[int, int]:
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms, cuda_build.nn_sweep_resident()


def card_plan(n: int, device, src_live: int | None = None) -> SweepPlan:
    """:func:`plan` for this card (its SM count and the kernel's resident
    blocks per SM, queried once) under ``SPLIT_CAP``; ``src_live`` is
    the device's bound, which only a caller that reads it back knows."""
    return plan(n, *_card_slots(torch.device(device).index or 0), src_live, SPLIT_CAP)


def _launch(src4, tgt4, src_live, live_hi, best_score, best_idx, rows=None) -> None:
    """The kernel of ``csrc/nn_sweep.cu`` (the key fill and both passes)
    on :func:`_pack`'s outputs, with the card's resident slots and
    ``SPLIT_CAP``, and its ``uint64[n]`` keys allocated here; ``rows``,
    where given, is the int64 counter the kernel adds ``src_live`` to.
    Counts no launch: the wrappers do."""
    n = src4.shape[0]
    sms, resident = _card_slots(src4.device.index or 0)
    keys = torch.empty((n,), dtype=torch.int64, device=src4.device)
    code = cuda_build.library().rspc_nn_sweep(
        src4.data_ptr(), tgt4.data_ptr(), src_live.data_ptr(), live_hi.data_ptr(), n,
        sms * resident, SPLIT_CAP, keys.data_ptr(),
        None if rows is None else rows.data_ptr(), best_score.data_ptr(),
        best_idx.data_ptr(), cuda_build.stream_of(src4),
    )
    cuda_build.check(code, "rspc_nn_sweep")


def _scores_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid, route: str, centroid=None):
    """Both routes' launch: :func:`_pack`, then :func:`_launch`; the
    kernel's (best score, best index) per source, (+inf, 0) at and past
    the live source bound. ``route`` names the launch count. Traces the
    launch as the span ``nn.sweep``; while the tracer records, the kernel
    counts the source rows it covers (``src_live``) into the call's
    device counter ``nn.source_rows``."""
    n, m = src_xyz.shape[0], tgt_xyz.shape[0]
    with profiling.span("nn.sweep", route=route, sources=n, targets=m):
        packed = _pack(src_xyz, src_valid, tgt_xyz, tgt_valid, centroid)
        if n:
            _launch(*packed, profiling.device_count("nn.source_rows", src_xyz.device))
            cuda_build.LAUNCHES[route] += 1
    return packed[4], packed[5]


def _sweep_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid, route: str):
    """:func:`_scores_cuda`, then :func:`_rescore` with the ``< 1e29``
    winner check."""
    best_score, best_idx = _scores_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid, route)
    return _rescore(src_xyz, src_valid, tgt_xyz, tgt_valid, best_score,
                    best_idx, best_score < PENALTY_WINS)


def nearest_neighbors_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid):
    """The route of TPU kernel B1, ``rspc_tpu/ops/nn_pallas.py::_nn_kernel``
    (targets up to ``STREAM_TARGET``): the kernel of ``csrc/nn_sweep.cu``
    with the TPU wrapper's pre- and post-processing kept as they were, on
    the plan the kernel makes on the device (:func:`plan`).

    Pre (:func:`_pack`): recentre on the valid-target centroid; pack the
    target as (x, y, z, |t|^2 + penalty) with the 1e30 penalty on invalid
    rows; the live bounds of the sources and of the target (highest valid
    index + 1) are reduced on the device and the kernel reads them from
    device memory, so nothing syncs with the host: it sweeps only the
    live source prefix against the live target prefix.
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


def _route(m: int) -> str:
    return "nn_sweep_split" if streams(m) else "nn_sweep"


def nn_scores(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk: int = 2048, centroid=None):
    """Each source's winning (score, index) before the re-score, by the
    dispatch of :func:`nn_sweep`, recentred on ``centroid`` (default the
    valid-target centroid). The score is ``|t|^2 - 2 s.t`` in recentred
    coordinates, plus the kernels' 1e30 penalty on invalid targets (the
    plain sweep: inf); a winner scoring 1e29 or more found no valid
    target. An invalid source scores inf with index 0 in the plain sweep
    and on the card at and past the live source bound; the kernels sweep
    the invalid sources before it."""
    if src_xyz.is_cuda:
        return _scores_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid,
                            _route(tgt_xyz.shape[0]), centroid)
    return _plain_scores(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk, centroid)


def nn_sweep(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk: int = 2048):
    """Device dispatch: for CUDA tensors B2's route where :func:`streams`
    holds for the target's capacity, else B1's; the plain sweep for CPU
    tensors. ``chunk`` only shapes the plain sweep's tiles."""
    if src_xyz.is_cuda:
        if streams(tgt_xyz.shape[0]):
            return nearest_neighbors_stream_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid)
        return nearest_neighbors_cuda(src_xyz, src_valid, tgt_xyz, tgt_valid)
    return nearest_neighbors(src_xyz, src_valid, tgt_xyz, tgt_valid, chunk)
