"""The robust presets end to end against the JAX package (CPU): 3
JAX-rendered 160x120 frames of a partial-overlap trajectory (11.5 deg
yaw and 12 cm per frame, the robustness matrix's ``partial_overlap`` and
``combined`` motion at this size), through ``NDTEdgeBasedRegistration``
under ``robust_config(anchor_mode="map")`` on the fused chain and on the
``use_scan=False`` loop, with ``color=True`` and with ``pose_graph=True``
(skips 1, 2, 3), each configuration scaled to the frame size (NDT source
1024 points on a 16^3 grid, 4096 edge points, 2048 voxels, the anchors
on 1024 of 2048 refine points). The gated rescue fires on every pair of
this trajectory and keeps its correction.

The port's phase 1 gets the JAX package's edge clouds (with their
intensity gradients under ``color``) swapped in, as
tests/test_torch_edge_schemes.py does: the jitted JAX Canny breaks exact
NMS ties on flat texture differently, which moves these totals by about
5e-3 end to end; the chain, the rescue, the anchors and the pose graph
are compared alone. The refine clouds are each package's own.

Tolerances: totals max-abs <= 5e-4 (5.3e-6 measured), the same converged
and anchor-accepted flags, finite global clouds; the fused path's
``_out["full_down"]`` holds the stacked refine clouds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rspc_tpu.capture.synthetic import SyntheticSequence
from rspc_tpu.ops.deproject import Intrinsics
from rspc_tpu.presets import robust_config as j_robust
from rspc_tpu.registration.schemes import NDTEdgeBasedRegistration as JReg
from rspc_tpu_torch.interop import cloud_from_numpy, config_from_dict
from rspc_tpu_torch.registration import chainscan as tchain
from rspc_tpu_torch.registration.schemes import NDTEdgeBasedRegistration

W, H, N, YAW, STEP = 160, 120, 3, -0.2, (0.1, 0.0, 0.06)
TOTALS_TOL = 5e-4
CASES = {
    "map_fused": ({"anchor_mode": "map"}, True),
    "map_loop": ({"anchor_mode": "map"}, False),
    "color": ({"anchor_mode": "map", "color": True}, True),
    "graph": ({"anchor_mode": "map", "pose_graph": True}, True),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scaled(kw, scan):
    cfg = j_robust(**kw)
    r = dataclasses.replace
    return r(cfg, ndt=r(cfg.ndt, max_source_points=1024, dense_grid_dim=16),
             edge=r(cfg.edge, max_edge_points=4096), voxel=r(cfg.voxel, max_points=2048),
             refine=r(cfg.refine, max_points=2048, anchor_max_points=1024), use_scan=scan)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=N, yaw_step=YAW, translation_step=STEP,
                             intr=Intrinsics.simple(W, H))


@pytest.fixture(scope="module")
def clouds(seq):
    return seq.clouds()


def _summary(scheme, result):
    t = scheme.total_transforms
    return {
        "totals": t.numpy() if torch.is_tensor(t) else np.asarray(t),
        "converged": [bool(f.converged) for _, f in scheme.results],
        "accepted": np.asarray(scheme.anchor_accepted).tolist(),
        "finite": bool(np.isfinite(np.asarray(result.xyz)).all()),
        "scheme": scheme,
    }


@pytest.fixture(scope="module")
def runs(clouds):
    """Each case through both packages; the port on the JAX package's
    edge clouds (from its fused runs' phase 1; the loop case's edge
    configuration is the fused map case's)."""
    frames = [cloud_from_numpy({k: np.asarray(getattr(c, k)) for k in ("xyz", "rgb", "valid")},
                               organized=True) for c in clouds]
    real = tchain.extract_edge_features_batch
    out, feats = {}, None
    for name, (kw, scan) in CASES.items():
        cfg = scaled(kw, scan)
        jscheme = JReg(rads=YAW, config=cfg)
        want = _summary(jscheme, jscheme.registration(clouds))
        if scan:
            stacked = jscheme._fused_out[0]["features"]
            feats = [cloud_from_numpy({k: np.asarray(getattr(stacked, k))[i]
                                       for k in ("xyz", "rgb", "valid", "normal", "cgrad")
                                       if getattr(stacked, k) is not None})
                     for i in range(N)]

        def jax_edges(clouds_, edge_cfg, feats=feats):
            _, normals, n_valid = real(clouds_, edge_cfg)
            return feats, normals, n_valid

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tchain, "extract_edge_features_batch", jax_edges)
            tscheme = NDTEdgeBasedRegistration(
                rads=YAW, config=config_from_dict(dataclasses.asdict(cfg)))
            got = _summary(tscheme, tscheme.registration(frames))
        out[name] = (want, got)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_robust_preset_matches_jax(runs, seq, name):
    want, got = runs[name]
    assert got["totals"].shape == (N - 1, 4, 4)
    err = np.abs(got["totals"] - want["totals"]).max()
    assert err <= TOTALS_TOL, err
    assert got["converged"] == want["converged"]
    assert got["accepted"] == want["accepted"]
    assert got["finite"] and want["finite"]
    for i in range(1, N):  # both within the robustness matrix's order
        assert np.abs(got["totals"][i - 1] - seq.gt_transform(i)).max() < 5e-2


def test_fused_path_keeps_the_refine_clouds(runs):
    scheme = runs["map_fused"][1]["scheme"]
    full = scheme._out["full_down"]
    assert full.valid.shape == (N, 2048) and full.normal is not None
    assert runs["map_loop"][1]["scheme"]._out is None


def test_color_run_carries_gradients(runs):
    scheme = runs["color"][1]["scheme"]
    assert scheme.config.icp.color_weight > 0 and scheme.config.edge.carry_cgrad
    assert scheme._out["target"].cgrad is not None
    assert bool((scheme._out["target"].cgrad.abs().sum(-1) > 0).any())
