"""The port's trajectory-adaptive ``auto`` scheme
(``registration/auto.py``) against the JAX package (CPU).

Tolerances:
  * ``detect_closures``, ``closure_pairs``, ``build_ladder``, ``select``,
    ``collapse_signature``, ``colored_tiebreak``: equal outputs;
  * ``texture_score``: 1e-6;
  * ``_consistency_score`` on the same clouds and poses (geometric, and
    with the photometric term): 1e-5;
  * ``auto_register(..., candidates={north_star, robust_map}, fast=False)``
    end to end on 3 JAX-rendered 160x120 frames yawing 5.7 deg and moving
    3.6 cm per frame (the configurations scaled to the frame size; on a
    harder trajectory the north star's chain fails and the two packages'
    failed chains part by 3e-3 in score): the same selected candidate,
    every candidate's group scores within 1e-4 (3e-5 measured) and the
    winner's totals within 5e-4. The port's phase 1 gets the JAX
    package's edge clouds swapped in (as tests/test_torch_robust_paths.py
    does, for the same NMS-tie reason).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.capture.synthetic import SyntheticSequence
from rspc_tpu.cloud import Cloud as JCloud
from rspc_tpu.ops.deproject import Intrinsics
from rspc_tpu.presets import north_star_config as j_north_star
from rspc_tpu.presets import robust_config as j_robust
from rspc_tpu.registration import auto as jauto
from rspc_tpu.registration.chainscan import _prepare_full_down as j_full_down
from rspc_tpu.config import EdgeConfig as JEdgeConfig
from rspc_tpu_torch.interop import cloud_from_numpy, config_from_dict
from rspc_tpu_torch.registration import auto as tauto
from rspc_tpu_torch.registration import chainscan as tchain

W, H, N, YAW, STEP = 160, 120, 3, -0.1, (0.03, 0.0, 0.02)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _yaw_guesses(yaws):
    g = []
    for y in yaws[1:]:
        t = np.eye(4, dtype=np.float32)
        c, s = np.cos(y - yaws[0]), np.sin(y - yaws[0])
        t[0, 0], t[0, 2], t[2, 0], t[2, 2] = c, s, -s, c
        g.append(t)
    return np.stack(g)


TRAJECTORIES = {
    "out_and_back": [-0.2 * y for y in (0, 1, 2, 3, 4, 5, 4, 3, 2, 1)],
    "monotonic": [-0.08 * i for i in range(10)],
    "return_home": [0.0, -0.1, -0.2, -0.1, 0.0, 0.01],
}


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_detect_closures_and_pairs_equal(name):
    g = _yaw_guesses(TRAJECTORIES[name])
    want = jauto.detect_closures(g)
    assert tauto.detect_closures(g) == want
    assert (len(want) > 0) == (name != "monotonic")
    n = g.shape[0] + 1
    assert tauto.closure_pairs(n, want) == jauto.closure_pairs(n, want)


@pytest.mark.parametrize("texture,closures", [(0.0005, ()), (0.0016, ()), (0.005, (4, 6)),
                                              (0.0008, (8,))])
def test_build_ladder_equal(texture, closures):
    want = jauto.build_ladder(texture, closures)
    got = tauto.build_ladder(texture, closures)
    assert list(got) == list(want)
    for k in want:
        assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k])


def test_select_collapse_and_tiebreak_equal():
    rng = np.random.default_rng(0)
    names = ["north_star", "robust_map", "robust_color", "robust_graph"]
    for trial in range(200):
        k = rng.integers(1, 5)
        groups = rng.integers(1, 4)
        base = rng.uniform(0.1, 0.9, groups)
        scores = {n: tuple(base + rng.normal(0, 0.03, groups)) for n in names[:k]}
        if trial % 7 == 0:
            scores = {n: float(v[0]) for n, v in scores.items()}  # scalars
        margin = float(rng.choice([0.0, 0.015, 0.05]))
        w = jauto.select(scores, margin)
        assert tauto.select(scores, margin) == w
        inl = rng.integers(0, 1200, rng.integers(0, 10))
        collapsed = jauto.collapse_signature(inl)
        assert tauto.collapse_signature(inl) == collapsed
        for c in (collapsed, True):
            assert tauto.colored_tiebreak(w, scores, c, margin) == jauto.colored_tiebreak(
                w, scores, c, margin)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=N, yaw_step=YAW, translation_step=STEP,
                             intr=Intrinsics.simple(W, H))


@pytest.fixture(scope="module")
def clouds(seq):
    return seq.clouds()


@pytest.fixture(scope="module")
def frames(clouds):
    return [cloud_from_numpy({k: np.asarray(getattr(c, k)) for k in ("xyz", "rgb", "valid")},
                             organized=True) for c in clouds]


def test_texture_score_matches(clouds, frames):
    want = jauto.texture_score(clouds)
    assert want > 0.001
    assert abs(tauto.texture_score(frames) - want) <= 1e-6


@pytest.mark.parametrize("color_weight", [0.0, 1.0])
def test_consistency_score_matches(clouds, seq, color_weight):
    full = [j_full_down(c, JEdgeConfig(), 0.04, 2048, 2, 0.995) for c in clouds]
    fields = {k: np.stack([np.asarray(getattr(f, k)) for f in full])
              for k in ("xyz", "rgb", "valid")}
    rng = np.random.default_rng(3)
    totals = np.stack([seq.gt_transform(i) for i in range(1, N)]).astype(np.float32)
    totals[:, :3, 3] += rng.normal(0, 0.01, (N - 1, 3)).astype(np.float32)
    groups = (((0, 1), (1, 2)), ((0, 2),))
    want = np.asarray(jauto._consistency_score(
        JCloud(**{k: jnp.asarray(v) for k, v in fields.items()}), jnp.asarray(totals),
        groups, 0.05, color_weight=color_weight))
    got = tauto._consistency_score(cloud_from_numpy(fields), torch.from_numpy(totals), groups,
                                   0.05, color_weight=color_weight).numpy()
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _scaled(cfg):
    r = dataclasses.replace
    return r(cfg, ndt=r(cfg.ndt, max_source_points=1024, dense_grid_dim=16),
             edge=r(cfg.edge, max_edge_points=4096), voxel=r(cfg.voxel, max_points=2048),
             refine=r(cfg.refine, max_points=2048, anchor_max_points=1024))


@pytest.fixture(scope="module")
def auto_runs(clouds, frames):
    cands = {"north_star": _scaled(j_north_star()),
             "robust_map": _scaled(j_robust(anchor_mode="map"))}
    want = jauto.auto_register(clouds, rads=YAW, candidates=cands, fast=False)
    stacked = want.scheme._fused_out[0]["features"]
    feats = [cloud_from_numpy({k: np.asarray(getattr(stacked, k))[i]
                               for k in ("xyz", "rgb", "valid", "normal")})
             for i in range(N)]
    real = tchain.extract_edge_features_batch

    def jax_edges(clouds_, edge_cfg):
        _, normals, n_valid = real(clouds_, edge_cfg)
        return feats, normals, n_valid

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tchain, "extract_edge_features_batch", jax_edges)
        got = tauto.auto_register(
            frames, rads=YAW, fast=False,
            candidates={k: config_from_dict(dataclasses.asdict(v)) for k, v in cands.items()})
    return want, got


def test_auto_register_selects_like_jax(auto_runs):
    want, got = auto_runs
    assert got.selected == want.selected
    assert got.escalated and want.escalated
    assert got.closures == want.closures == ()
    assert abs(got.texture - want.texture) <= 1e-6
    assert list(got.scores) == list(want.scores) == ["north_star", "robust_map"]
    for k in want.scores:
        np.testing.assert_allclose(got.scores[k], want.scores[k], rtol=0, atol=1e-4)
    err = np.abs(got.total_transforms.numpy() - np.asarray(want.total_transforms)).max()
    assert err <= 5e-4, err
    assert got.scheme.config == config_from_dict(dataclasses.asdict(want.scheme.config))
    assert torch.isfinite(got.global_cloud.xyz).all()
