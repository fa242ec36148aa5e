"""Trajectory-adaptive robust registration, the ``auto`` scheme (port of
``rspc_tpu/registration/auto.py``).

No single preset wins every trajectory: the colored fine stage owns the
texture-starved drift wall but regresses loop trajectories, the pose
graph needs closure structure, and the plain north-star preset beats
every robust mechanism on clean scenes. ``auto_register`` measures
instead of guessing:

1. a candidate ladder, simplest first: the north star, the robust
   map-anchored stack, and, only where the trajectory's own signals
   justify them, the colored fine stage (texture present) and the pose
   graph (closure structure in the guesses);
2. each candidate runs the whole registration;
3. each run's trajectory is scored without ground truth: the capped
   mean-square NN consistency (plus a photometric term when texture is
   present) over validation pair GROUPS (sequential pairs, mid-skip
   pairs, detected closure pairs) on the full voxel-downsampled clouds
   at the candidate's final poses;
4. the simplest candidate is kept unless a challenger improves some
   group by ``margin`` without regressing any other (:func:`select`).

The fast path runs the first candidate alone and stops unless the
trajectory looks hard (closures, the inlier-collapse signature, or a
sequential-group score above ``escalate_score``). The JAX package's
module records the measurements behind each constant.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from rspc_tpu_torch.cloud import Cloud
from rspc_tpu_torch.ops.colorgrad import intensity
from rspc_tpu_torch.ops.transform import apply_transform_cloud
from rspc_tpu_torch.registration.measures import _capped_sum, _nn_sweep


def detect_closures(guesses: np.ndarray, rot_tol: float = 0.03,
                    trans_tol: float = 0.05, min_skip: int = 4) -> tuple:
    """Skip offsets at which the guessed trajectory re-observes itself:
    pairs (i, j), j - i >= ``min_skip``, whose guessed relative motion
    is under ``rot_tol`` rad and ``trans_tol`` m. ``guesses`` are the
    scheme's ``[n-1, 4, 4]`` absolute initial transforms (host arrays);
    returns the sorted offsets, the format of
    ``RefineConfig.pose_graph_skips``."""
    g = np.asarray(guesses, np.float64)
    n = g.shape[0] + 1
    abs_p = np.concatenate([np.eye(4)[None], g], axis=0)
    skips = set()
    for i in range(n):
        for j in range(i + min_skip, n):
            rel = np.linalg.inv(abs_p[i]) @ abs_p[j]
            ang = float(np.arccos(np.clip((np.trace(rel[:3, :3]) - 1.0) / 2.0, -1, 1)))
            if ang < rot_tol and np.linalg.norm(rel[:3, 3]) < trans_tol:
                skips.add(j - i)
    return tuple(sorted(skips))


def closure_pairs(n: int, skips: Sequence[int]) -> list:
    """All (i, j) frame pairs implied by closure skip offsets."""
    return [(i, i + off) for off in skips for i in range(n - off)]


def texture_score(clouds, max_frames: int = 3) -> float:
    """Mean absolute image-space intensity step over valid pixel pairs of
    the first ``max_frames`` organized frames: is there texture for the
    colored residual to use."""
    vals = []
    for c in clouds[:max_frames]:
        i = intensity(c.rgb)
        gx = (i[:, 1:] - i[:, :-1]).abs()
        gy = (i[1:] - i[:-1]).abs()
        vx = c.valid[:, 1:] & c.valid[:, :-1]
        vy = c.valid[1:] & c.valid[:-1]
        s = torch.where(vx, gx, 0.0).sum() + torch.where(vy, gy, 0.0).sum()
        m = vx.sum() + vy.sum()
        vals.append(float(s / torch.clamp(m, min=1)))
    return float(np.mean(vals))


def _consistency_score(fulls: Cloud, totals: torch.Tensor, pair_groups: tuple,
                       radius: float, color_weight: float = 0.0) -> torch.Tensor:
    """Per-group trajectory consistency at the given absolute poses,
    without ground truth: for every validation pair (i, j) of a group,
    frame j's full cloud against frame i's, both placed by their poses.
    Geometric term: the capped mean-square NN distance over radius^2
    (far points saturate at the cap); photometric term (``color_weight``
    > 0): the mean-square intensity difference at the inlier matches.
    Each group pools its pairs' sums (one NN sweep per pair). Returns
    ``f32[len(pair_groups)]``."""
    dtype, dev = totals.dtype, totals.device
    eye = torch.eye(4, dtype=dtype, device=dev)
    abs_p = torch.cat([eye[None], totals], dim=0)
    cap2 = radius * radius
    scores = []
    for pairs in pair_groups:
        num = den = cnum = cden = torch.zeros((), dtype=dtype, device=dev)
        for i, j in pairs:
            src = apply_transform_cloud(abs_p[j], fulls.map(lambda x: x[j]))
            tgt = apply_transform_cloud(abs_p[i], fulls.map(lambda x: x[i]))
            d2, idx = _nn_sweep(src.xyz, src.valid, tgt.xyz, tgt.valid)
            s, m = _capped_sum(d2, src.valid, radius)
            num, den = num + s, den + m
            if color_weight > 0.0:
                ib = intensity(src.rgb)
                it = intensity(fulls.rgb[i].index_select(0, idx.long()))
                w = (src.valid & (d2 < cap2)).to(dtype)
                cnum = cnum + ((ib - it) ** 2 * w).sum()
                cden = cden + w.sum()
        score = num / torch.clamp(den, min=1.0) / cap2
        if color_weight > 0.0:
            score = score + color_weight * cnum / torch.clamp(cden, min=1.0)
        scores.append(score)
    return torch.stack(scores)


@dataclasses.dataclass
class AutoResult:
    """Outcome of :func:`auto_register`."""

    global_cloud: Cloud
    total_transforms: torch.Tensor
    selected: str          # winning candidate name
    scores: dict           # name -> per-group consistency tuple (ran candidates)
    closures: tuple        # detected closure skip offsets
    texture: float         # measured texture score
    scheme: object         # the winning scheme instance
    escalated: bool = True  # False: the fast path kept the first candidate


def build_ladder(texture: float, closures: tuple, texture_min: float = 0.001) -> dict:
    """The candidate ladder, simplest first: the colored fine stage only
    when ``texture`` reaches ``texture_min``, the pose graph (skips
    {1, 2, 3} and the closures) only when there are closures."""
    from rspc_tpu_torch.presets import north_star_config, robust_config

    candidates = {"north_star": north_star_config(),
                  "robust_map": robust_config(anchor_mode="map")}
    if texture >= texture_min:
        candidates["robust_color"] = robust_config(anchor_mode="map", color=True)
    if closures:
        cfg_g = robust_config(anchor_mode="map", pose_graph=True)
        candidates["robust_graph"] = dataclasses.replace(
            cfg_g, refine=dataclasses.replace(
                cfg_g.refine, pose_graph_skips=tuple(sorted({1, 2, 3} | set(closures)))),
        )
    return candidates


def _vec(v):
    return tuple(v) if hasattr(v, "__len__") else (v,)


def select(scores: dict, margin: float) -> str:
    """Hysteresis selection over an ordered {name: score vector} dict
    (simplest first, lower is better): a challenger takes over when some
    group beats the incumbent's by more than ``margin`` (absolute, in
    the score's normalized units) and no group is worse by more than
    ``margin``. Scalars count as 1-vectors."""
    names = list(scores)
    winner = names[0]
    for name in names[1:]:
        cur, inc = _vec(scores[name]), _vec(scores[winner])
        wins = any(i - c > margin for c, i in zip(cur, inc))
        safe = all(c - i <= margin for c, i in zip(cur, inc))
        if wins and safe:
            winner = name
    return winner


def collapse_signature(fine_inliers, frac: float = 0.15) -> bool:
    """The texture-starved drift signature: the late third's minimum
    fine-cap inlier count under ``frac`` of the early third's maximum
    (``fine_inliers``: per-pair n_correspondences of a finished run)."""
    fine_inl = np.asarray(fine_inliers, np.float64)
    if fine_inl.size < 2:
        return False
    third = max(2, fine_inl.size // 3)
    early = float(fine_inl[:third].max())
    late = float(fine_inl[-third:].min())
    return early > 0 and late / max(early, 1.0) < frac


def colored_tiebreak(winner: str, scores: dict, collapsed: bool, margin: float) -> str:
    """The colored candidate takes the win when the collapse signature
    fired on the winning run, it ran, and it is within ``margin`` of the
    incumbent on every group; otherwise the incumbent stays."""
    if not collapsed or "robust_color" not in scores or winner == "robust_color":
        return winner
    cur, inc = _vec(scores["robust_color"]), _vec(scores[winner])
    within = all(c - i <= margin for c, i in zip(cur, inc))
    return "robust_color" if within else winner


def auto_register(clouds, thetas: Optional[np.ndarray] = None, rads: Optional[float] = None,
                  margin: float = 0.015, texture_min: float = 0.001,
                  score_radius: float = 0.05, candidates: Optional[dict] = None,
                  fast: bool = True, escalate_score: float = 0.30) -> AutoResult:
    """Register organized ``clouds`` (on the card, or wherever the caller
    put them) with measured candidate selection (module docstring).
    ``thetas``/``rads`` follow the schemes' constructors; ``candidates``
    overrides the ladder as an ordered {name: PipelineConfig} dict;
    ``fast`` runs the first candidate alone unless closures, the
    collapse signature or a sequential-group score above
    ``escalate_score`` say the trajectory is hard."""
    from rspc_tpu_torch.registration.schemes import NDTEdgeBasedRegistration

    n = len(clouds)
    guess_kw = {"thetas": thetas} if thetas is not None else {}
    if thetas is None and rads is not None:
        guess_kw = {"rads": rads}

    # trajectory signals (no registration output needed)
    probe = NDTEdgeBasedRegistration(**guess_kw)
    guesses = probe._guesses(n, clouds[0].xyz.device).cpu().numpy()
    closures = detect_closures(guesses)
    tex = texture_score(clouds)
    if candidates is None:
        candidates = build_ladder(tex, closures, texture_min)

    # validation pair groups: sequential, mid-skip, closure pairs
    mid = max(2, min(4, n - 1))
    groups = [tuple((i, i + 1) for i in range(n - 1)),
              tuple((i, i + mid) for i in range(n - mid))]
    if closures:
        groups.append(tuple(closure_pairs(n, closures)))
    pair_groups = tuple(g for g in groups if g)
    score_color = 1.0 if tex >= texture_min else 0.0

    runs, scores = {}, {}
    fulls_ref = None

    def run_and_score(name, cfg):
        nonlocal fulls_ref
        s = NDTEdgeBasedRegistration(config=cfg, **guess_kw)
        g = s.registration(clouds)
        if fulls_ref is None:
            # one full-cloud set scores every candidate: the clouds are
            # pose-independent data
            fd = s._out["full_down"]
            fulls_ref = Cloud(xyz=fd.xyz, rgb=fd.rgb, valid=fd.valid)
        runs[name] = (s, g)
        scores[name] = tuple(float(v) for v in _consistency_score(
            fulls_ref, s.total_transforms, pair_groups, score_radius,
            color_weight=score_color).cpu())

    names = list(candidates)
    run_and_score(names[0], candidates[names[0]])
    escalate = (
        not fast
        or len(names) == 1
        or bool(closures)
        or collapse_signature([int(f.n_correspondences) for _, f in runs[names[0]][0].results])
        # the sequential group: its floor is trajectory-independent
        or scores[names[0]][0] > escalate_score
    )
    if escalate:
        for name in names[1:]:
            run_and_score(name, candidates[name])

    winner = select(scores, margin)
    if "robust_color" in runs and winner != "robust_color":
        collapsed = collapse_signature(
            [int(f.n_correspondences) for _, f in runs[winner][0].results])
        winner = colored_tiebreak(winner, scores, collapsed, margin)

    s, g = runs[winner]
    return AutoResult(global_cloud=g, total_transforms=s.total_transforms, selected=winner,
                      scores=scores, closures=closures, texture=tex, scheme=s,
                      escalated=escalate)
