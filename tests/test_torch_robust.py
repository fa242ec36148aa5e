"""The port's robust registration stack against the JAX package (CPU):
the intensity-gradient field, the colored and point-mixed fits and ICP,
the SE(3) pose graph, the gated rescue, the map anchor, the pose-graph
glue and the colored anchor rows, on seeded numpy inputs and
JAX-rendered 160x120 frames.

Tolerances (max-abs, against the JAX package on the same inputs):
  * ``intensity``, ``_solve3`` (symmetric and non-symmetric matrices):
    1e-5 relative to the solution's magnitude;
  * ``color_gradients`` on the JAX package's normals: 1e-5; its voxel
    means on the refine cloud: 2e-5 relative to max(1, |value|) (means
    of dozens of gradients up to 200/m, summed in another order; 1.04e-5
    measured);
  * ``plane_fit`` with colored rows and ``point_mix``: 1e-5;
  * ``icp_align`` with ``color_weight`` > 0 and with ``point_plane_mix``
    > 0: 1e-5, the same state and iteration count;
  * ``se3_exp``/``se3_log`` and their forward-mode Jacobian at the
    identity: finite and within 1e-5;
  * ``optimize_pose_graph`` on a noisy synthetic graph: 1e-4;
  * ``_rescue_from``: the same gate outcome, the transform within 1e-5;
  * ``_anchor_refine_map``, ``_pose_graph_refine`` (also with every
    constraint's weight 0, where the priors take weight 1) and the
    colored, point-mixed ``_anchor_refine``: 1e-4 and the same accepted
    flags.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.capture.synthetic import SyntheticSequence
from rspc_tpu.cloud import Cloud as JCloud
from rspc_tpu.config import EdgeConfig as JEdgeConfig
from rspc_tpu.config import ICPConfig as JICPConfig
from rspc_tpu.ops import colorgrad as jcg
from rspc_tpu.ops.deproject import Intrinsics
from rspc_tpu.ops.normals import estimate_normals as j_normals
from rspc_tpu.ops.umeyama import plane_fit as j_plane_fit
from rspc_tpu.presets import robust_config as j_robust
from rspc_tpu.registration import anchor as janchor
from rspc_tpu.registration import pairsteps as jps
from rspc_tpu.registration import posegraph as jpg
from rspc_tpu.registration.chainscan import _prepare_full_down as j_full_down
from rspc_tpu.registration.icp import icp_align as j_icp
from rspc_tpu.registration.measures import _inlier_stats as j_inlier_stats
from rspc_tpu_torch.config import ICPConfig
from rspc_tpu_torch.interop import cloud_from_numpy, config_from_dict
from rspc_tpu_torch.ops import colorgrad as tcg
from rspc_tpu_torch.ops.umeyama import plane_fit
from rspc_tpu_torch.registration import anchor as tanchor
from rspc_tpu_torch.registration import pairsteps as tps
from rspc_tpu_torch.registration import posegraph as tpg
from rspc_tpu_torch.registration.chainscan import _prepare_full_down
from rspc_tpu_torch.registration.icp import icp_align

W, H, N = 160, 120, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(c, keys=("xyz", "rgb", "valid", "normal", "cgrad")):
    return {k: np.asarray(getattr(c, k)) for k in keys if getattr(c, k, None) is not None}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    err = np.abs(got - np.asarray(want)).max()
    assert err <= tol, err


# ------------------------------------------------------- intensity gradients


def test_intensity_matches_jax():
    rgb = np.random.default_rng(0).uniform(0, 255, (40, 30, 3)).astype(np.float32)
    _close(tcg.intensity(_t(rgb)), jcg.intensity(jnp.asarray(rgb)), 1e-6)


@pytest.mark.parametrize("kind", ["symmetric", "general"])
def test_solve3_matches_jax(kind):
    rng = np.random.default_rng(1)
    m = rng.normal(size=(500, 3, 3)).astype(np.float32)
    if kind == "symmetric":
        m = m @ m.transpose(0, 2, 1)
    m[:5] = 0.0  # singular rows return 0
    b = rng.normal(size=(500, 3)).astype(np.float32)
    want = np.asarray(jcg._solve3(jnp.asarray(m), jnp.asarray(b), 1e-6))
    got = tcg._solve3(_t(m), _t(b), 1e-6).numpy()
    assert not got[:5].any()
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= 1e-5, err.max()
    if kind == "general":
        # the adjugate-column determinant solves a non-symmetric system
        ok = np.abs(np.linalg.det(m)) > 1e-2
        np.testing.assert_allclose(got[ok], np.linalg.solve(m[ok], b[ok][..., None])[..., 0],
                                   rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def textured_frame():
    seq = SyntheticSequence(n_frames=2, yaw_step=-0.1, intr=Intrinsics.simple(W, H))
    return seq.clouds()[1]


def test_color_gradients_match_jax(textured_frame):
    oc = textured_frame
    nrm, nv = j_normals(oc, JEdgeConfig())
    want = np.asarray(jcg.color_gradients(oc, nrm, nv))
    port = cloud_from_numpy(_np(oc, ("xyz", "rgb", "valid")), organized=True)
    got = tcg.color_gradients(port, _t(nrm), _t(nv)).numpy()
    assert np.abs(want).max() > 0.1 and (np.abs(want).sum(-1) > 0).mean() > 0.1
    _close(got, want, 1e-5)


def test_prepare_full_down_carries_cgrad_like_jax(textured_frame):
    oc = textured_frame
    want = j_full_down(oc, JEdgeConfig(), 0.04, 2048, 2, 0.995, True)
    port = cloud_from_numpy(_np(oc, ("xyz", "rgb", "valid")), organized=True)
    nrm, nv = j_normals(oc, JEdgeConfig())
    got = _prepare_full_down(port, _t(nrm), _t(nv), 0.04, 2048, 2, 0.995, True)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = np.asarray(want.valid)
    _close(got.xyz.numpy()[v], np.asarray(want.xyz)[v], 1e-5)
    cg = np.asarray(want.cgrad)[v]
    rel = np.abs(got.cgrad.numpy()[v] - cg) / np.maximum(np.abs(cg), 1.0)
    assert rel.max() <= 2e-5, rel.max()


# ------------------------------------------------------- fits and ICP


def test_plane_fit_colored_and_point_mix_match_jax():
    rng = np.random.default_rng(2)
    n = 600
    src = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    dst = (src + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    w = (rng.random(n) < 0.9).astype(np.float32)
    g = rng.normal(0, 3.0, (n, 3)).astype(np.float32)
    di = rng.normal(0, 0.02, n).astype(np.float32)
    wc = (w * rng.uniform(0.5, 2.0, n)).astype(np.float32)
    for mix in (0.0, 0.1):
        want = j_plane_fit(*map(jnp.asarray, (src, dst, nrm, w)), point_mix=mix,
                           cgrad=jnp.asarray(g), color_resid=jnp.asarray(di),
                           color_weights=jnp.asarray(wc))
        got = plane_fit(*map(_t, (src, dst, nrm, w)), point_mix=mix, cgrad=_t(g),
                        color_resid=_t(di), color_weights=_t(wc))
        _close(got, want, 1e-5)
    want = j_plane_fit(*map(jnp.asarray, (src, dst, nrm, w)), point_mix=0.3)
    _close(plane_fit(*map(_t, (src, dst, nrm, w)), point_mix=0.3), want, 1e-5)


def _textured_corner(n, seed):
    """Points on three orthogonal planes with unit normals, a sinusoidal
    grey texture and its exact tangent-plane intensity gradient."""
    rng = np.random.default_rng(seed)
    k = n // 3
    pts, nrm = [], []
    for axis in range(3):
        p = rng.uniform(0.0, 1.0, (k, 3))
        p[:, axis] = 0.0
        m = np.zeros((k, 3))
        m[:, axis] = 1.0
        pts.append(p)
        nrm.append(m)
    pts, nrm = np.concatenate(pts), np.concatenate(nrm)
    a = np.array([9.0, 7.0, 5.0])
    grey = 128.0 + 100.0 * np.sin(pts @ a)
    grad = (100.0 / 255.0) * np.cos(pts @ a)[:, None] * a
    grad -= nrm * (grad * nrm).sum(-1, keepdims=True)
    f = lambda x: x.astype(np.float32)
    return f(pts), f(np.repeat(grey[:, None], 3, 1)), f(nrm), f(grad)


def _rigid(angle, axis, t):
    from scipy.spatial.transform import Rotation

    m = np.eye(4)
    m[:3, :3] = Rotation.from_rotvec(angle * np.asarray(axis, float)).as_matrix()
    m[:3, 3] = t
    return m.astype(np.float32)


@pytest.mark.parametrize("kind", ["color", "point_mix"])
def test_icp_colored_and_point_mix_match_jax(kind):
    pts, rgb, nrm, grad = _textured_corner(3000, 3)
    t_true = _rigid(0.02, (0.3, 1.0, 0.2), (0.01, -0.008, 0.012))
    sel = np.random.default_rng(4).permutation(len(pts))[:1500]
    inv = np.linalg.inv(t_true)
    src = (pts[sel] @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    tgt = dict(xyz=pts, rgb=rgb, valid=np.ones(len(pts), bool), normal=nrm, cgrad=grad)
    srcd = dict(xyz=src, rgb=rgb[sel], valid=np.ones(len(src), bool))
    kw = dict(max_iterations=15, max_correspondence_distance=0.05,
              transformation_epsilon=1e-10, euclidean_fitness_epsilon=1e-10,
              target_chunk=1024, variant="point_to_plane", huber_delta=0.01)
    kw.update(color_weight=2.0) if kind == "color" else kw.update(point_plane_mix=0.2)
    jcfg = JICPConfig(**kw)
    want = j_icp(JCloud(**{k: jnp.asarray(v) for k, v in srcd.items()}),
                 JCloud(**{k: jnp.asarray(v) for k, v in tgt.items()}), jcfg)
    got = icp_align(cloud_from_numpy(srcd), cloud_from_numpy(tgt),
                    config_from_dict(dataclasses.asdict(jcfg), ICPConfig))
    _close(got.transform, want.transform, 1e-5)
    assert int(got.state) == int(want.state)
    assert int(got.iterations) == int(want.iterations)
    assert np.abs(got.transform.numpy() - t_true).max() < 5e-3


# ------------------------------------------------------- SE(3) and the graph


def test_se3_exp_log_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.3, (20, 6)).astype(np.float32)
    x[0] = 0.0
    x[1, :3] = 1e-5  # the Taylor branches
    for row in x:
        want_t = jpg.se3_exp(jnp.asarray(row))
        got_t = tpg.se3_exp(_t(row))
        _close(got_t, want_t, 1e-6)
        _close(tpg.se3_log(got_t), jpg.se3_log(want_t), 1e-5)
    _close(tpg._inv(tpg.se3_exp(_t(x[3]))), jpg._inv(jpg.se3_exp(jnp.asarray(x[3]))), 1e-6)


def test_se3_jacobian_at_identity_finite_and_equal():
    """Forward-mode Jacobians at zero, where the plain forms divide by
    zero. The port's inputs carry a batch axis of 1, as in the pose
    graph (under ``torch.func`` a 0-d intermediate times a Python float
    promotes the tangent to float64)."""
    m = jpg.se3_exp(jnp.asarray([0.05, -0.02, 0.03, 0.1, 0.0, -0.05], jnp.float32))
    t_m = _t(m)
    pairs = (
        (lambda x: jpg.se3_log(m @ jpg.se3_exp(x)), lambda x: tpg.se3_log(t_m @ tpg.se3_exp(x))),
        (jpg.se3_exp, tpg.se3_exp),
        (lambda x: jpg.se3_log(jpg.se3_exp(x)), lambda x: tpg.se3_log(tpg.se3_exp(x))),
    )
    for f_j, f_t in pairs:
        want = np.asarray(jax.jacfwd(f_j)(jnp.zeros(6, jnp.float32)))
        got = torch.func.jacfwd(f_t)(torch.zeros(1, 6))
        assert got.dtype == torch.float32
        got = got.reshape(want.shape).numpy()
        assert np.isfinite(got).all() and np.isfinite(want).all()
        _close(got, want, 1e-5)


def _noisy_graph(n=7, seed=6):
    rng = np.random.default_rng(seed)
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        step = np.asarray(jpg.se3_exp(jnp.asarray(rng.normal(0, [0.05] * 3 + [0.1] * 3),
                                                  jnp.float32)))
        gt.append(gt[-1] @ step)
    gt = np.stack(gt).astype(np.float32)
    ei, ej, meas, w = [], [], [], []
    for off in (1, 2, 3):
        for i in range(n - off):
            rel = np.linalg.inv(gt[i]) @ gt[i + off]
            noise = np.asarray(jpg.se3_exp(jnp.asarray(rng.normal(0, 0.01, 6), jnp.float32)))
            ei.append(i), ej.append(i + off), meas.append(rel @ noise)
            w.append(0.0 if len(w) == 3 else rng.uniform(50, 400))
    totals = np.stack([gt[i] @ np.asarray(jpg.se3_exp(jnp.asarray(
        rng.normal(0, 0.02, 6), jnp.float32))) for i in range(1, n)]).astype(np.float32)
    return (totals, np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.stack(meas).astype(np.float32), np.asarray(w, np.float32))


def test_optimize_pose_graph_matches_jax():
    args = _noisy_graph()
    want, want_cost = jpg.optimize_pose_graph(*map(jnp.asarray, args))
    got, got_cost = tpg.optimize_pose_graph(*map(_t, args))
    _close(got, want, 1e-4)
    np.testing.assert_allclose(got_cost.numpy(), np.asarray(want_cost), rtol=1e-3)
    assert float(got_cost[-1]) < float(got_cost[0])


# ------------------------------------------------------- the rescue


def _corner(spacing=0.01, extent=0.5, seed=0):
    ax = np.arange(0.0, extent, spacing, dtype=np.float32)
    u, v = (a.ravel() for a in np.meshgrid(ax, ax, indexing="ij"))
    z = np.zeros_like(u)
    pts = np.concatenate([np.stack([u, v, z], -1), np.stack([u, z, v], -1),
                          np.stack([z, u, v], -1)])
    pts = pts + np.random.default_rng(seed).normal(0, 2e-4, pts.shape)
    pts = pts.astype(np.float32)
    return dict(xyz=pts, rgb=np.full_like(pts, 128.0), valid=np.ones(len(pts), bool))


@pytest.mark.parametrize("offset", [(0.04, 0.02, 0.03), (0.0, 0.0, 0.0)],
                         ids=["fires", "stays"])
def test_rescue_from_matches_jax(offset):
    tgt = _corner()
    cur = _corner(seed=1)
    cur["xyz"] = cur["xyz"] + np.asarray(offset, np.float32)
    jcur, jtgt = (JCloud(**{k: jnp.asarray(v) for k, v in c.items()}) for c in (cur, tgt))
    cfg = JICPConfig(target_chunk=2048)
    n_inl, _ = j_inlier_stats(jcur, jtgt, cfg.max_correspondence_distance, False)
    want, want_need = jps._rescue_from(jcur, jtgt, n_inl, cfg, 0.1, 8, 0.55)
    got, got_need = tps._rescue_from(cloud_from_numpy(cur), cloud_from_numpy(tgt),
                                     _t(n_inl), config_from_dict(dataclasses.asdict(cfg),
                                                                 ICPConfig), 0.1, 8, 0.55)
    assert bool(got_need) == bool(want_need) == (offset[0] > 0)
    _close(got, want, 1e-5)
    if offset[0] > 0:  # the rescue was kept and moved the cloud back
        assert np.abs(got.numpy()[:3, 3] + np.asarray(offset)).max() < 1e-2


# ------------------------------------------------------- anchors


@pytest.fixture(scope="module")
def fulls():
    """Stacked refine clouds (normals and intensity gradients) of a
    4-frame 160x120 sequence, the ground-truth totals, and the totals
    moved off it by about a centimetre and half a degree."""
    seq = SyntheticSequence(n_frames=N, yaw_step=-0.15, translation_step=(0.05, 0.0, 0.03),
                            intr=Intrinsics.simple(W, H))
    clouds = seq.clouds()
    full = [j_full_down(c, JEdgeConfig(), 0.02, 2048, 2, 0.995, True) for c in clouds]
    stacked = {k: np.stack([np.asarray(getattr(f, k)) for f in full])
               for k in ("xyz", "rgb", "valid", "normal", "cgrad")}
    gt = np.stack([seq.gt_transform(i) for i in range(1, N)]).astype(np.float32)
    rng = np.random.default_rng(7)
    off = np.stack([_rigid(0.01, rng.normal(size=3) / np.sqrt(3), rng.normal(0, 0.01, 3))
                    for _ in range(N - 1)])
    return stacked, gt, (gt @ off).astype(np.float32)


def _jfull(stacked, keys=("xyz", "rgb", "valid", "normal")):
    return JCloud(**{k: jnp.asarray(stacked[k]) for k in keys})


def _tfull(stacked, keys=("xyz", "rgb", "valid", "normal")):
    return cloud_from_numpy({k: stacked[k] for k in keys})


def test_anchor_refine_map_matches_jax(fulls):
    stacked, gt, totals = fulls
    r = j_robust(anchor_mode="map").refine
    stages = janchor._map_anchor_stages(r.anchor_stages)
    want, want_acc = janchor._anchor_refine_map(
        _jfull(stacked), jnp.asarray(totals), stages, r.map_accept_margin,
        r.gate_radius, r.gate_inlier_keep, r.gate_rmse_blowup)
    tstages = tuple(config_from_dict(dataclasses.asdict(s), ICPConfig) for s in r.anchor_stages)
    got, got_acc = tanchor._anchor_refine_map(
        _tfull(stacked), _t(totals), tstages, r.map_accept_margin, r.gate_radius,
        r.gate_inlier_keep, r.gate_rmse_blowup)
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    assert got_acc.any() and torch.isfinite(got).all()
    _close(got, want, 1e-4)


@pytest.mark.parametrize("min_overlap", [0.25, 2.0], ids=["weighted", "all_zero"])
def test_pose_graph_refine_matches_jax(fulls, min_overlap):
    """With ``min_overlap`` 2.0 no pair keeps a weight, the median of no
    weights is NaN and the priors take weight 1: the graph returns the
    totals it was given."""
    stacked, gt, totals = fulls
    r = j_robust(anchor_mode="map", pose_graph=True).refine
    want = janchor._pose_graph_refine(_jfull(stacked), jnp.asarray(totals),
                                      r.anchor_stages, (1, 2, 3), r.gate_radius,
                                      min_overlap=min_overlap, max_points=1024)
    tstages = tuple(config_from_dict(dataclasses.asdict(s), ICPConfig)
                    for s in r.anchor_stages)
    got = tanchor._pose_graph_refine(_tfull(stacked), _t(totals), tstages, (1, 2, 3),
                                     r.gate_radius, min_overlap=min_overlap,
                                     max_points=1024)
    assert torch.isfinite(got).all()
    _close(got, want, 1e-4)
    if min_overlap > 1.0:
        _close(got, totals, 1e-5)


def test_anchor_refine_colored_and_mixed_rows_match_jax(fulls):
    stacked, gt, totals = fulls
    base = j_robust().refine.anchor_stages
    stages = (dataclasses.replace(base[0], color_weight=2.0, point_plane_mix=0.1),
              dataclasses.replace(base[1], color_weight=1.0))
    keys = ("xyz", "rgb", "valid", "normal", "cgrad")
    jf = _jfull(stacked, keys)
    first = jax.tree.map(lambda x: x[0], jf)
    rest = jax.tree.map(lambda x: x[1:], jf)
    want, want_acc = janchor._anchor_refine(first, rest, jnp.asarray(totals), stages, 1.0,
                                            max_points=1024)
    tf = _tfull(stacked, keys)
    got, got_acc = tanchor._anchor_refine(
        tf.map(lambda x: x[0]), tf.map(lambda x: x[1:]), _t(totals),
        tuple(config_from_dict(dataclasses.asdict(s), ICPConfig) for s in stages), 1.0,
        max_points=1024)
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    _close(got, want, 1e-4)
