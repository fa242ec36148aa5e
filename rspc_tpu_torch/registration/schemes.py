"""Registration schemes (port of ``rspc_tpu/registration/schemes.py``),
after the reference's Strategy / template-method design
(src/types.hpp:14-44):

  * ``TwoPhaseRegistrationScheme`` -- phase 1 ``extract_features`` per
    cloud, phase 2 ``global_registration``;
  * ``ICPEdgeBasedRegistration`` -- coarse ICP + fine ICP on RGB-edge
    clouds with IMU or static guesses, writing ``edge-{i}.pcd`` and
    ``edge_cloud.pcd`` beside it (``--all``; reference C4);
  * ``NDTEdgeBasedRegistration`` -- NDT coarse + fine ICP on RGB-edge
    clouds (``--registration``; reference C5);
  * ``IncrementalICP`` -- guess-free ICP of each full cloud against the
    accumulated target (reference C3).

The edge schemes label organized frames of one shape in one batch, then
run clouds of one capacity through the fused chain
(``chainscan.py::_chain_scan``: convergence gates fold into the merges,
no host sync decides one) and anything else, or every input under
``PipelineConfig.use_scan=False``, through the per-frame loop, whose
merges read ``bool(fine.converged)`` (one host sync per pair).

Reference quirks kept (SURVEY.md section 7): the stored edge cloud of
frame 0 is voxel-downsampled in place, so ``edge-0.pcd`` holds the
downsampled cloud; IMU thetas are rebased by -theta_0 (theta_0 itself
is not); the static-guess accumulator advances for every frame,
converged or not; the ICP scheme's IMU guess maps all three axes, the
NDT scheme's only -theta.y. And one of the JAX package's own: the loop
path refines every pair whenever ``refine.enabled``, the fused path only
under ``refine.chain`` (ROADMAP.md Queue C).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from rspc_tpu_torch.cloud import Cloud, OrganizedCloud
from rspc_tpu_torch.config import PipelineConfig
from rspc_tpu_torch.ops.edges import extract_edge_features
from rspc_tpu_torch.ops.normals import estimate_normals
from rspc_tpu_torch.ops.transform import apply_transform_cloud
from rspc_tpu_torch.ops.voxel import voxel_downsample
from rspc_tpu_torch.registration.anchor import _refine_step
from rspc_tpu_torch.registration.bufferops import (
    _as_unorganized,
    _block_append,
    _rigid_inverse,
    merge_append,
)
from rspc_tpu_torch.registration.chainscan import (
    _anchor_stages,
    _assemble_global,
    _phase1_prepare,
    _prepare_full_down,
    _registration_body,
    _stack,
)
from rspc_tpu_torch.registration.icp import ICPResult, icp_align
from rspc_tpu_torch.registration.pairsteps import (
    _icp_pair_step,
    _imu_guesses,
    _ndt_pair_step,
)
from rspc_tpu_torch.utils import profiling


class RegistrationScheme:
    """Abstract base (reference: src/types.hpp:14-20)."""

    def registration(self, clouds: Sequence) -> Cloud:
        raise NotImplementedError


class TwoPhaseRegistrationScheme(RegistrationScheme):
    """Template method: extract features per cloud, then register them
    globally (reference: src/types.hpp:22-44)."""

    def extract_features(self, cloud):
        raise NotImplementedError

    def global_registration(self, clouds: List[Tuple[Cloud, Cloud]]) -> Cloud:
        raise NotImplementedError

    def batch_extract_features(self, clouds: Sequence):
        """Optional phase-1 fast path: the feature clouds of all inputs at
        once (None: the per-cloud loop)."""
        return None

    def registration(self, clouds: Sequence) -> Cloud:
        features = self.batch_extract_features(clouds)
        if features is None:
            features = [self.extract_features(c) for c in clouds]
        return self.global_registration(
            [(f, _as_unorganized(c)) for f, c in zip(features, clouds)]
        )


def _uniform_organized(clouds) -> bool:
    return (len(clouds) >= 2
            and all(isinstance(c, OrganizedCloud) for c in clouds)
            and len({(c.height, c.width) for c in clouds}) == 1)


class _EdgeBasedRegistration(TwoPhaseRegistrationScheme):
    """The skeleton shared by the ICP- and NDT-based edge schemes. The
    constructor overloads mirror the reference: no guess (the static
    ``config.default_rads`` per frame), IMU ``thetas`` (``[n, 3]``, one
    per frame) or a user ``rads``. ``results`` holds one ``(coarse,
    fine)`` pair per registered frame, ``total_transforms`` the
    ``[n-1, 4, 4]`` transforms of frames 1..n-1 into frame 0."""

    use_ndt_coarse = False
    saves_edge_pcds = False

    def __init__(
        self,
        thetas=None,
        rads: Optional[float] = None,
        config: PipelineConfig = PipelineConfig(),
        dataset_dir: Optional[str] = None,
    ):
        self.config = config
        self.use_imu = thetas is not None
        self.thetas = (None if thetas is None
                       else torch.as_tensor(thetas, dtype=torch.float32))
        self.rads = float(rads) if rads is not None else config.default_rads
        self.dataset_dir = dataset_dir
        self.results: List[Tuple[object, ICPResult]] = []
        self.refine_results: List[ICPResult] = []
        self.total_transforms = None
        self.anchor_accepted = None
        self._full_down: Optional[List[Cloud]] = None
        self._out = None

    def registration(self, clouds: Sequence) -> Cloud:
        """The template of ``TwoPhaseRegistrationScheme`` plus the refine
        stage's clouds: phase 1 (batched for organized frames of one
        shape), then ``global_registration``."""
        cfg = self.config
        r = cfg.refine
        self._full_down = None
        self.anchor_accepted = None
        if r.enabled and not all(isinstance(c, OrganizedCloud) for c in clouds):
            raise ValueError(
                "the refine stage needs organized input clouds "
                "(normal estimation is image-shaped)"
            )
        features = self.batch_extract_features(clouds)
        if features is None:
            features = [self.extract_features(c) for c in clouds]
        if r.enabled and self._full_down is None:
            self._full_down = [
                _prepare_full_down(c, *estimate_normals(c, cfg.edge), r.leaf_size,
                                   r.max_points, r.decimate, r.normal_purity, r.color)
                for c in clouds
            ]
        return self.global_registration(
            [(f, _as_unorganized(c)) for f, c in zip(features, clouds)]
        )

    def extract_features(self, cloud):
        if not isinstance(cloud, OrganizedCloud):
            raise ValueError(
                "edge-based registration needs organized clouds "
                "(PCL OrganizedEdgeFromRGBNormals requires an organized input)"
            )
        return extract_edge_features(cloud, self.config.edge)

    def batch_extract_features(self, clouds):
        """Phase 1 for organized frames of one shape, labelled together;
        with the refine stage on, the refine clouds come from the same
        normal images (kept for phase 2)."""
        if not _uniform_organized(clouds):
            return None
        r = self.config.refine
        feats, full = _phase1_prepare(
            list(clouds), self.config.edge, r.leaf_size, r.max_points, r.enabled,
            r.decimate, r.normal_purity, r.color,
        )
        if r.enabled:
            self._full_down = [full.map(lambda x: x[i]) for i in range(len(clouds))]
        return [feats.map(lambda x: x[i]) for i in range(len(clouds))]

    def _guesses(self, n: int, device) -> torch.Tensor:
        """Stacked ``[n-1, 4, 4]`` initial guesses. The static accumulator
        advances for every frame, converged or not (reference :98-101), so
        all guesses exist up front: static ones built host-side in numpy
        (float64 angles), IMU ones from the rebased thetas on ``device``."""
        if self.use_imu:
            if self.thetas.shape[0] != n:
                raise ValueError(
                    f"{self.thetas.shape[0]} thetas for {n} clouds"
                )
            return _imu_guesses(self.thetas.to(device), self.use_ndt_coarse)
        acc = self.rads * np.arange(1, n, dtype=np.float64)
        c, s = np.cos(acc), np.sin(acc)
        t = np.tile(np.eye(4, dtype=np.float32), (n - 1, 1, 1))
        t[:, 0, 0] = c
        t[:, 0, 2] = s
        t[:, 2, 0] = -s
        t[:, 2, 2] = c
        return torch.from_numpy(t).to(device)

    def _dump_edges(self, edges: List[Cloud], target: Optional[Cloud]) -> None:
        """``edge-{i}.pcd`` per frame and ``edge_cloud.pcd`` (the
        accumulated edge target) into ``dataset_dir``, valid points only
        (icp_edge_based_registration.hpp:66-69,126)."""
        if not (self.saves_edge_pcds and self.dataset_dir is not None):
            return
        from rspc_tpu_torch.io.pcd import save_pcd

        os.makedirs(self.dataset_dir, exist_ok=True)
        for i, e in enumerate(edges):
            save_pcd(os.path.join(self.dataset_dir, f"edge-{i}.pcd"), e,
                     keep_invalid=False)
        if target is not None:
            save_pcd(os.path.join(self.dataset_dir, "edge_cloud.pcd"), target,
                     keep_invalid=False)

    def global_registration(self, clouds: List[Tuple[Cloud, Cloud]]) -> Cloud:
        """Phase 2 over (edge cloud, original cloud) pairs: the chain of
        ``_chain_scan`` when ``use_scan`` and the clouds are uniform, else
        the per-frame loop."""
        cfg = self.config
        edges = [c[0] for c in clouds]
        originals = [c[1] for c in clouds]
        uniform = (
            len(clouds) >= 2
            and len({e.capacity for e in edges}) == 1
            and len({o.capacity for o in originals}) == 1
            and len({e.normal is None for e in edges}) == 1
        )
        if cfg.use_scan and uniform:
            return self._global_registration_scan(edges, originals)
        return self._global_registration_loop(edges, originals)

    def _anchor(self, totals):
        """The refinements after the chain that the config asks for (the
        anchor against frame 0 or the progressive map, the pose graph):
        (totals, accepted or None)."""
        if not self.config.refine.enabled:
            return totals, None
        return _anchor_stages(_stack(self._full_down), totals, self.config.refine)

    def _global_registration_scan(self, edges: List[Cloud],
                                  originals: List[Cloud]) -> Cloud:
        """The fused path: ``chainscan.py::_registration_body`` (the chain,
        the anchor and pose graph, the global cloud) on the stacked edge
        and refine clouds."""
        cfg = self.config
        full = _stack(self._full_down) if cfg.refine.enabled else None
        out = _registration_body(
            _stack(edges), full, originals, self._guesses(len(edges), edges[0].device),
            cfg, self.use_ndt_coarse,
        )
        self._out = out
        self.results = list(zip(out["coarse"], out["fine"]))
        self.refine_results = out["refine"]
        self.total_transforms = out["totals"]
        self.anchor_accepted = out["anchor_accepted"]
        self._dump_edges([out["edges_down0"]] + list(edges[1:]), out["target"])
        return out["global"]

    def _global_registration_loop(self, edges: List[Cloud],
                                  originals: List[Cloud]) -> Cloud:
        """The per-frame loop (``use_scan=False``): one pair step at a
        time, each merge decided on the host by ``bool(fine.converged)``;
        the warm start's local correction updates under the same test."""
        cfg = self.config
        r = cfg.refine
        n = len(edges)
        dev = edges[0].device
        voxel_cap = cfg.voxel.max_points
        guesses = self._guesses(n, dev)

        # frame 0's edges are downsampled IN PLACE in the reference, so
        # edge-0.pcd holds the downsampled cloud
        target0 = voxel_downsample(edges[0], cfg.voxel.leaf_size, voxel_cap)
        target = merge_append(
            Cloud.empty(voxel_cap * n, dev, with_normal=target0.normal is not None,
                        with_cgrad=target0.cgrad is not None),
            target0,
        )
        global_cloud = merge_append(
            Cloud.empty(sum(o.capacity for o in originals), dev), originals[0]
        )
        edges = [target0] + list(edges[1:])
        if r.enabled:
            target_full = merge_append(
                Cloud.empty(r.max_points * n, dev, with_normal=True),
                self._full_down[0],
            )
        self._dump_edges(edges, None)

        self.results, self.refine_results, totals = [], [], []
        self._out = None
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        prev_total = c_local = eye
        warm = cfg.coarse_warm_start
        robust_kw = dict(rescue_thresh=cfg.rescue_inlier_frac, rescue_cap=cfg.rescue_cap,
                         rescue_iters=cfg.rescue_iterations)
        for idx in range(1, n):
            guess = raw_guess = guesses[idx - 1]
            if warm:
                # the constant-velocity prediction (see _chain_scan)
                rel_g = (guesses[0] if idx == 1
                         else _rigid_inverse(guesses[idx - 2]) @ guesses[idx - 1])
                guess = prev_total @ rel_g @ c_local
            robust_kw["guard_fallback"] = raw_guess if warm else None
            if self.use_ndt_coarse:
                coarse, fine, fine_aligned = _ndt_pair_step(
                    target, edges[idx], guess, cfg.ndt, cfg.icp,
                    cfg.voxel.leaf_size, voxel_cap, cfg.coarse_guard_cap, **robust_kw,
                )
            else:
                coarse, fine, fine_aligned = _icp_pair_step(
                    target, edges[idx], guess, cfg.icp, cfg.voxel.leaf_size,
                    voxel_cap, cfg.coarse_guard_cap, **robust_kw,
                )
            self.results.append((coarse, fine))
            total = fine.transform @ coarse.transform
            if r.enabled:
                ref, accepted, total = _refine_step(
                    target_full, self._full_down[idx], total, r.stages,
                    r.accept_margin,
                )
                self.refine_results.append(ref)
                # the last stage's increment only, as the JAX package does
                delta = torch.where(accepted, ref.transform, eye)
                fine_aligned = apply_transform_cloud(delta, fine_aligned)
            totals.append(total)
            converged = bool(fine.converged)  # host sync: the loop path's merge test
            if warm:
                # local correction gated on convergence, the prediction
                # anchor ungated (see _chain_scan)
                if converged:
                    c_local = _rigid_inverse(rel_g) @ _rigid_inverse(prev_total) @ total
                prev_total = total
            if converged:
                target = merge_append(target, fine_aligned)
                if r.enabled:
                    target_full = merge_append(
                        target_full, apply_transform_cloud(total, self._full_down[idx])
                    )
                global_cloud = merge_append(
                    global_cloud, apply_transform_cloud(total, originals[idx])
                )

        totals_arr = torch.stack(totals) if totals else None
        if totals_arr is not None:
            totals_arr, self.anchor_accepted = self._anchor(totals_arr)
        self.total_transforms = totals_arr
        self._dump_edges([], target)
        if self.anchor_accepted is not None:
            # the anchored transforms supersede the in-loop merges
            conv = torch.tensor([bool(f.converged) for _, f in self.results],
                                device=dev)
            return _assemble_global(originals, totals_arr, conv | self.anchor_accepted)
        return global_cloud


class ICPEdgeBasedRegistration(_EdgeBasedRegistration):
    """Coarse ICP + fine ICP on RGB-edge clouds; ``--all`` (reference C4).
    Writes ``edge-{i}.pcd`` and ``edge_cloud.pcd`` when given a
    ``dataset_dir`` (icp_edge_based_registration.hpp:66-69,126)."""

    use_ndt_coarse = False
    saves_edge_pcds = True


class NDTEdgeBasedRegistration(_EdgeBasedRegistration):
    """NDT coarse + fine ICP on RGB-edge clouds; ``--registration``
    (reference C5). Writes no edge clouds."""

    use_ndt_coarse = True
    saves_edge_pcds = False


def _incremental_scan(clouds: List[Cloud], icp_cfg, leaf: float,
                      voxel_cap: int, cap: int):
    """The whole incremental chain on the scan path: the downsamples of
    frames 1..n-1 up front (they do not depend on the target), then per
    pair ICP against the accumulated full-resolution target and a block
    append of the transformed frame at offset ``frame_cap * i``. The
    pair's convergence gates its block's ``valid`` on the device, so no
    host sync decides a merge (the JAX ``lax.scan`` becomes this loop)."""
    first, rest = clouds[0], clouds[1:]
    frame_cap = first.capacity
    with profiling.span("map.append"):
        target = _block_append(Cloud.empty(cap, first.device, first.xyz.dtype), first, 0)
    src_downs = [voxel_downsample(c, leaf, voxel_cap) for c in rest]
    results = []
    for i, (src_down, cloud_i) in enumerate(zip(src_downs, rest), start=1):
        res = icp_align(src_down, target, icp_cfg)
        with profiling.span("map.append"):
            transformed = apply_transform_cloud(res.transform, cloud_i)
            target = _block_append(target, transformed, frame_cap * i,
                                   gate=res.converged)
        results.append(res)
    return target, results


class IncrementalICP(RegistrationScheme):
    """Plain (non-edge) incremental registration (reference C3,
    src/incremental_icp.hpp): per cloud i >= 1, voxel-downsample the
    source, ICP against the accumulated target with NO initial guess, and
    on convergence merge the transformed full cloud. ``results`` holds
    one ``ICPResult`` per registered pair."""

    def __init__(self, config: PipelineConfig = PipelineConfig()):
        self.config = config
        self.results: List[ICPResult] = []

    def registration(self, clouds: Sequence) -> Cloud:
        with profiling.call("incremental.registration", frames=len(clouds)):
            return self._registration([_as_unorganized(c) for c in clouds])

    def _registration(self, clouds: List[Cloud]) -> Cloud:
        cfg = self.config
        cap = sum(c.capacity for c in clouds)
        if (
            cfg.use_scan
            and len(clouds) >= 2
            and len({c.capacity for c in clouds}) == 1
            and len({c.normal is None for c in clouds}) == 1
        ):
            target, self.results = _incremental_scan(
                clouds, cfg.icp, cfg.voxel.leaf_size, cfg.voxel.max_points, cap,
            )
            return target
        with profiling.span("map.append"):
            target = merge_append(Cloud.empty(cap, clouds[0].device), clouds[0])
        self.results = []
        for cloud in clouds[1:]:
            # the loop path: voxel-downsample the source, ICP it against
            # the accumulated target with no guess, and merge the
            # transformed full cloud where the pair converged
            src_down = voxel_downsample(cloud, cfg.voxel.leaf_size, cfg.voxel.max_points)
            res = icp_align(src_down, target, cfg.icp)
            self.results.append(res)
            with profiling.wait("merge"):
                merge = bool(res.converged)  # host sync: the loop path's merge test
            if merge:
                with profiling.span("map.append"):
                    target = merge_append(target, apply_transform_cloud(res.transform, cloud))
        return target
