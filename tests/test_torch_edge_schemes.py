"""The 5-class edge labeler, the edge schemes (``ICPEdgeBasedRegistration``
and ``NDTEdgeBasedRegistration`` with IMU thetas, fused and loop paths,
the in-chain refine) and the PCD writer of the port against the JAX
package (CPU), on the 3-frame 80x60 sequence and ``_small_config()`` of
tests/test_pipeline.py (whose EdgeConfig enables all five classes).

Tolerances:
  * depth label classes (nan_boundary, occluding, occluded): exact;
  * high-curvature and RGB classes: bracketed as in
    tests/test_torch_image_ops.py (test_canny_bounded_by_jitted_jax): the
    port's class lies between the hysteresis of the jitted JAX masks with
    the pixels within 1e-4 relative of a threshold or of an NMS
    neighbour forced off and forced on; every other pixel's label equal;
  * the schemes on the JAX package's edge clouds (phase 1 swapped in, so
    that the chain is compared alone; phase 1 is held above): the same
    converged flags, totals max-abs <= 5e-4 (as tests/test_torch_slice.py),
    the side PCDs written by both with the same per-frame edge files;
  * the schemes end to end on the port's own phase 1: the same converged
    flags as JAX and both within the rotation/translation bounds of
    tests/test_pipeline.py (the jitted JAX Canny breaks exact NMS ties on
    flat texture differently, about 5% of the edge pixels at 80x60,
    which moves these small-frame totals by about 1.3e-3; at 160x120
    under the north-star configuration the end-to-end totals are held
    to 5e-4 in tests/test_torch_slice.py);
  * 5-class runs against ``("rgb_canny",)`` runs: equal totals (RGB_CANNY
    is written last, so the other classes cannot change the edge cloud);
  * port fused against port loop: max-abs <= 2e-4 (tests/test_pipeline.py);
  * ``save_pcd``: the JAX package's bytes in all three encodings (its
    Python LZF compressor; the native one may choose other matches), and
    ``load_pcd`` round trips.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.capture.synthetic import DepthNoise, SyntheticSequence
from rspc_tpu.cloud import Cloud as JCloud
from rspc_tpu.cloud import OrganizedCloud as JOrganized
from rspc_tpu.config import (
    EdgeConfig,
    ICPConfig,
    NDTConfig,
    PipelineConfig,
    RefineConfig,
    VoxelConfig,
)
from rspc_tpu.io import native as jnative
from rspc_tpu.io import pcd as jpcd
from rspc_tpu.ops.deproject import Intrinsics
from rspc_tpu.ops.edges import extract_organized_edges as j_labels
from rspc_tpu.ops.normals import estimate_normals as j_normals
from rspc_tpu.registration import schemes as js
from rspc_tpu_torch.config import EdgeConfig as TEdgeConfig
from rspc_tpu_torch.interop import cloud_from_numpy, config_from_dict
from rspc_tpu_torch.io import native as tnative
from rspc_tpu_torch.io import pcd as tpcd
from rspc_tpu_torch.ops import edges as tedges
from rspc_tpu_torch.registration import chainscan as tchain
from rspc_tpu_torch.registration import schemes as ts

jcanny = importlib.import_module("rspc_tpu.ops.canny")
jimage = importlib.import_module("rspc_tpu.ops.image")

W, H, N, YAW = 80, 60, 3, -0.07
TOTALS_TOL = 5e-4
PATHS_TOL = 2e-4
REL = 1e-4
DEPTH_TYPES = ("nan_boundary", "occluding", "occluded")


def _small_config(**kw):
    """tests/test_pipeline.py's ``_small_config``."""
    kw.setdefault("edge", EdgeConfig(max_edge_points=2048))
    return PipelineConfig(
        icp=ICPConfig(
            max_iterations=30,
            transformation_epsilon=1e-8,
            euclidean_fitness_epsilon=1e-12,
            max_correspondence_distance=0.25,
            target_chunk=512,
        ),
        ndt=NDTConfig(dense_grid_dim=16),
        voxel=VoxelConfig(leaf_size=0.05, max_points=2048),
        **kw,
    )


# the in-chain refine, with a margin that accepts any improvement
REFINE = RefineConfig(enabled=True, leaf_size=0.1, max_points=1024, accept_margin=1.0)
RUNS = {
    "icp": (js.ICPEdgeBasedRegistration, ts.ICPEdgeBasedRegistration, {}),
    "ndt": (js.NDTEdgeBasedRegistration, ts.NDTEdgeBasedRegistration, {}),
    "icp_refine": (js.ICPEdgeBasedRegistration, ts.ICPEdgeBasedRegistration,
                   {"refine": REFINE}),
}
CASES = [(name, scan) for name in RUNS for scan in (True, False)]


def _np(c, keys=("xyz", "rgb", "valid")):
    return {k: np.asarray(getattr(c, k)) for k in keys if getattr(c, k) is not None}


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=N, yaw_step=YAW, intr=Intrinsics.simple(W, H))


@pytest.fixture(scope="module")
def clouds(seq):
    return seq.clouds()


@pytest.fixture(scope="module")
def frames(clouds):
    return [cloud_from_numpy(_np(c), organized=True) for c in clouds]


@pytest.fixture(scope="module")
def thetas(seq):
    return seq.thetas()


# ---------------------------------------------------------------- phase 1


@pytest.fixture(scope="module")
def holey():
    """Frames with 5% depth dropout: holes for the depth classes' search."""
    s = SyntheticSequence(n_frames=N, yaw_step=YAW, intr=Intrinsics.simple(W, H),
                          noise=DepthNoise(dropout=0.05))
    jc = s.clouds()
    return jc, [cloud_from_numpy(_np(c), organized=True) for c in jc]


@pytest.mark.parametrize("types", [DEPTH_TYPES, ("occluded", "nan_boundary")])
def test_depth_classes_exact(holey, types):
    jc, tc = holey
    want = np.stack([np.asarray(j_labels(c, EdgeConfig(edge_types=types))) for c in jc])
    got = tedges.extract_organized_edges_batch(tc, TEdgeConfig(edge_types=types)).numpy()
    assert got.dtype == np.int32 and got.shape == (N, H, W)
    for code, name in enumerate(DEPTH_TYPES, start=1):
        assert ((want == code).sum() > 50) == (name in types)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tedges.extract_organized_edges(tc[1], TEdgeConfig(edge_types=types)).numpy(), want[1])


def _bracket(mag, gx, gy, low, high, keep_fn):
    """(lower, upper) of Canny on the jitted JAX magnitudes: the
    hysteresis with the pixels near a threshold or an NMS tie forced off
    and forced on."""
    keep = np.asarray(keep_fn(jnp.asarray(mag), jnp.asarray(gx), jnp.asarray(gy)))
    tie = np.zeros(mag.shape, bool)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr or dc:
                nb = np.asarray(jimage.shift2d(jnp.asarray(mag), dr, dc))
                tie |= np.abs(mag - nb) <= REL * np.maximum(mag, 1.0)
    near = lambda t: np.abs(mag - t) <= REL * t
    unsure_w = (tie & (mag > low * (1 - REL))) | near(low)
    unsure_s = (tie & (mag > high * (1 - REL))) | near(high)
    mag_nms = np.where(keep, mag, 0.0)
    strong, weak = mag_nms > high, mag_nms > low
    hyst = lambda s, w: np.asarray(_j_hysteresis(jnp.asarray(s), jnp.asarray(w)))
    return (hyst(strong & ~unsure_s & ~unsure_w, weak & ~unsure_w),
            hyst(strong | unsure_s, weak | unsure_w))


_j_hysteresis = jax.jit(jcanny._hysteresis)
_j_normals = jax.jit(j_normals, static_argnums=1)


@jax.jit
def _rgb_gradients(rgb):
    s = jimage.conv2d_same(jnp.mean(rgb, axis=-1), jimage.gaussian_kernel_3x3(1.0))
    gx = jimage.conv2d_same(s, jimage.SOBEL_X)
    gy = jimage.conv2d_same(s, jimage.SOBEL_Y)
    return jnp.sqrt(gx * gx + gy * gy), gx, gy


@pytest.mark.parametrize("hc", [(0.4, 1.1), (0.05, 0.1)])
def test_five_class_labels_match(holey, hc):
    """The default config (whose unit normals never pass the 1.1 strong
    threshold, so HIGH_CURVATURE stays empty) and one with thresholds low
    enough for this mostly frontal scene to light it."""
    jc, tc = holey
    cfg = EdgeConfig(hc_canny_low_threshold=hc[0], hc_canny_high_threshold=hc[1])
    want = np.stack([np.asarray(j_labels(c, cfg)) for c in jc])
    got = tedges.extract_organized_edges_batch(
        tc, config_from_dict(dataclasses.asdict(cfg), TEdgeConfig)).numpy()
    unsure = np.zeros(got.shape, bool)
    for i, c in enumerate(jc):
        valid = np.asarray(c.valid)
        rgb_lo, rgb_hi = _bracket(*(np.asarray(a) for a in _rgb_gradients(c.rgb)),
                                  cfg.canny_low_threshold, cfg.canny_high_threshold,
                                  jcanny._nms)
        nrm, nv = (np.asarray(a) for a in _j_normals(c, cfg))
        mag = np.where(nv, np.sqrt(nrm[..., 0] ** 2 + nrm[..., 1] ** 2), 0.0).astype(np.float32)
        hc_lo, hc_hi = _bracket(mag, nrm[..., 0], nrm[..., 1], *hc, jcanny._nms)
        rgb, hcl = got[i] == 5, got[i] == 4
        assert (rgb_lo & valid <= rgb).all() and (rgb <= rgb_hi & valid).all()
        assert (hcl <= hc_hi & valid).all()
        assert (hc_lo & valid & ~rgb <= hcl).all()
        unsure[i] = (rgb_hi & ~rgb_lo) | (hc_hi & ~hc_lo)
        if hc == (0.4, 1.1):
            assert not hc_hi.any() and not hcl.any()
    assert (got == 5).sum() > 1000
    assert ((got == 4).sum() > 500) == (hc != (0.4, 1.1))
    np.testing.assert_array_equal(got[~unsure], want[~unsure])


def test_edge_cloud_compacts_one_class(holey):
    _, tc = holey
    labels = tedges.extract_organized_edges(tc[0], TEdgeConfig())
    for code in (1, 5):
        e = tedges.edge_cloud(tc[0], labels, code, 4096)
        n = int((labels == code).sum())
        assert e.capacity == 4096 and int(e.count()) == n > 0
        assert bool(e.valid[:n].all()) and not bool(e.valid[n:].any())


# ---------------------------------------------------------------- schemes


@pytest.fixture(scope="module")
def jax_features(clouds):
    """The JAX package's phase-1 edge clouds (all five classes labelled)."""
    feats = js.ICPEdgeBasedRegistration(config=_small_config()).batch_extract_features(clouds)
    return [_np(f, ("xyz", "rgb", "valid", "normal")) for f in feats]


def _summary(scheme, result):
    return {
        "totals": np.asarray(scheme.total_transforms.cpu() if torch.is_tensor(
            scheme.total_transforms) else scheme.total_transforms),
        "converged": [bool(f.converged) for _, f in scheme.results],
        "count": int(result.count()),
    }


@pytest.fixture(scope="module")
def jax_runs(clouds, thetas, tmp_path_factory):
    out = {}
    for name, scan in CASES:
        jcls, _, kw = RUNS[name]
        d = str(tmp_path_factory.mktemp(f"jax_{name}_{scan}"))
        scheme = jcls(thetas=thetas, config=_small_config(use_scan=scan, **kw),
                      dataset_dir=d)
        out[name, scan] = {**_summary(scheme, scheme.registration(clouds)), "dir": d}
    return out


@pytest.fixture(scope="module")
def port_runs(frames, thetas, jax_features, tmp_path_factory):
    """The port's schemes with the JAX package's edge clouds swapped into
    phase 1 (the port's own labels and normals still run)."""
    real = tchain.extract_edge_features_batch

    def jax_edges(clouds_, cfg):
        _, normals, n_valid = real(clouds_, cfg)
        return [cloud_from_numpy(f) for f in jax_features], normals, n_valid

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tchain, "extract_edge_features_batch", jax_edges)
        for name, scan in CASES:
            _, tcls, kw = RUNS[name]
            d = str(tmp_path_factory.mktemp(f"port_{name}_{scan}"))
            cfg = config_from_dict(dataclasses.asdict(_small_config(use_scan=scan, **kw)))
            scheme = tcls(thetas=thetas, config=cfg, dataset_dir=d)
            out[name, scan] = {**_summary(scheme, scheme.registration(frames)),
                               "dir": d, "scheme": scheme}
    return out


@pytest.mark.parametrize("name,scan", CASES)
def test_scheme_matches_jax(jax_runs, port_runs, name, scan):
    want, got = jax_runs[name, scan], port_runs[name, scan]
    assert got["totals"].shape == (N - 1, 4, 4)
    assert got["converged"] == want["converged"]
    assert all(got["converged"])
    err = np.abs(got["totals"] - want["totals"]).max()
    assert err <= TOTALS_TOL, err
    assert abs(got["count"] - want["count"]) <= 0.001 * want["count"]


@pytest.mark.parametrize("name,scan", [c for c in CASES if c[0] != "ndt"])
def test_icp_scheme_writes_edge_pcds(jax_runs, port_runs, name, scan):
    """edge-{i}.pcd and edge_cloud.pcd, written by both packages: frames
    1..n-1 byte for byte (the same edge clouds), frame 0 (downsampled in
    place) and the target with the same point counts."""
    want, got = jax_runs[name, scan]["dir"], port_runs[name, scan]["dir"]
    names = [f"edge-{i}.pcd" for i in range(N)] + ["edge_cloud.pcd"]
    assert sorted(os.listdir(got)) == sorted(os.listdir(want)) == sorted(names)
    read = lambda d, f: open(os.path.join(d, f), "rb").read()
    for f in names[1:N]:
        assert read(got, f) == read(want, f)
    for f in (names[0], names[-1]):
        a = tpcd.load_pcd(os.path.join(got, f), device="cpu")
        b = jpcd.load_pcd(os.path.join(want, f))
        assert int(a.count()) == int(b.count()) > 0
    out = port_runs[name, scan]["scheme"]._out
    if scan:  # the fused run's files are its stored clouds
        for f, cloud in ((names[0], out["edges_down0"]), (names[-1], out["target"])):
            back = tpcd.load_pcd(os.path.join(got, f), device="cpu")
            v = cloud.valid
            np.testing.assert_array_equal(back.xyz.numpy(), cloud.xyz[v].numpy())
            # colour is stored as packed 8-bit channels (voxel means truncate)
            np.testing.assert_array_equal(
                back.rgb.numpy(), np.trunc(np.clip(cloud.rgb[v].numpy(), 0, 255)))


@pytest.mark.parametrize("name", ["icp", "ndt"])
def test_global_registration_scan_branch(clouds, frames, thetas, jax_features, name):
    """``global_registration`` on (edge, original) pairs with ``use_scan``:
    the chain without phase 1, on the JAX package's edge clouds."""
    jcls, tcls, _ = RUNS[name]
    jscheme = jcls(thetas=thetas, config=_small_config())
    jscheme.global_registration(
        [(f, js._as_unorganized(c)) for f, c in
         zip(jscheme.batch_extract_features(clouds), clouds)])
    tscheme = tcls(thetas=thetas, config=config_from_dict(dataclasses.asdict(_small_config())))
    out = tscheme.global_registration(
        [(cloud_from_numpy(f), fr.flatten()) for f, fr in zip(jax_features, frames)])
    assert out.capacity == N * H * W
    assert [bool(f.converged) for _, f in tscheme.results] == [
        bool(f.converged) for _, f in jscheme.results]
    err = np.abs(tscheme.total_transforms.numpy() - np.asarray(jscheme.total_transforms)).max()
    assert err <= TOTALS_TOL, err


def test_pair_steps_refuse_the_robust_options(frames):
    from rspc_tpu_torch.registration.pairsteps import _icp_pair_step, _ndt_pair_step

    cfg = config_from_dict(dataclasses.asdict(_small_config()))
    edge = tedges.extract_edge_features(frames[0], cfg.edge)
    eye = torch.eye(4)
    for kw in ({"guard_fallback": eye}, {"rescue_thresh": 0.3}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _icp_pair_step(edge, edge, eye, cfg.icp, 0.05, 2048, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _ndt_pair_step(edge, edge, eye, cfg.ndt, cfg.icp, 0.05, 2048, **kw)


def test_ndt_scheme_writes_no_pcds(port_runs):
    assert os.listdir(port_runs["ndt", True]["dir"]) == []


def test_in_chain_refine_ran(port_runs):
    fused = port_runs["icp_refine", True]["scheme"]
    loop = port_runs["icp_refine", False]["scheme"]
    assert len(fused.refine_results) == len(loop.refine_results) == N - 1
    assert fused.refine_results[0].transform.shape == (4, 4)


@pytest.fixture(scope="module")
def own_runs(frames, thetas):
    """The port end to end on its own phase 1."""
    out = {}
    for types in (EdgeConfig().edge_types, ("rgb_canny",)):
        for scan in (True, False):
            cfg = _small_config(use_scan=scan,
                                edge=EdgeConfig(max_edge_points=2048, edge_types=types))
            scheme = ts.ICPEdgeBasedRegistration(
                thetas=thetas, config=config_from_dict(dataclasses.asdict(cfg)))
            out[len(types), scan] = _summary(scheme, scheme.registration(frames))
    return out


def test_own_phase1_end_to_end(seq, own_runs, jax_runs):
    got, want = own_runs[5, True], jax_runs["icp", True]
    assert got["converged"] == want["converged"]
    for i in range(1, N):
        gt = seq.gt_transform(i)
        for t in (got["totals"], want["totals"]):
            np.testing.assert_allclose(t[i - 1][:3, :3], gt[:3, :3], atol=0.03)
            np.testing.assert_allclose(t[i - 1][:3, 3], gt[:3, 3], atol=0.05)


@pytest.mark.parametrize("scan", [True, False])
def test_five_classes_equal_rgb_only(own_runs, scan):
    a, b = own_runs[5, scan], own_runs[1, scan]
    np.testing.assert_array_equal(a["totals"], b["totals"])
    assert a["converged"] == b["converged"] and a["count"] == b["count"]


def test_fused_and_loop_paths_agree(own_runs):
    a, b = own_runs[5, True], own_runs[5, False]
    assert a["converged"] == b["converged"]
    np.testing.assert_allclose(a["totals"], b["totals"], rtol=0, atol=PATHS_TOL)
    assert a["count"] == b["count"]


def test_unported_options_raise(frames):
    base = config_from_dict(dataclasses.asdict(_small_config()))
    r = dataclasses.replace
    for cfg in (
        r(base, edge=r(base.edge, carry_cgrad=True)),
        r(base, coarse_warm_start=True),
        r(base, rescue_inlier_frac=0.3),
        r(base, refine=r(base.refine, enabled=True, anchor_to_first=True, anchor_mode="map")),
        r(base, refine=r(base.refine, enabled=True, pose_graph=True)),
        r(base, refine=r(base.refine, enabled=True, color=True)),
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ts.ICPEdgeBasedRegistration(config=cfg).registration(frames)


def test_thetas_must_match_the_frames(frames, thetas):
    scheme = ts.NDTEdgeBasedRegistration(thetas=thetas[:2], config=config_from_dict(
        dataclasses.asdict(_small_config())))
    with pytest.raises(ValueError, match="thetas"):
        scheme.registration(frames)


# ---------------------------------------------------------------- PCD


def _pcd_clouds():
    rng = np.random.default_rng(0)
    xyz = rng.normal(0, 2, (300, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (300, 3)).astype(np.float32)
    valid = rng.random(300) < 0.8
    org_xyz = rng.normal(0, 2, (6, 8, 3)).astype(np.float32)
    org_rgb = rng.integers(0, 256, (6, 8, 3)).astype(np.float32)
    org_valid = rng.random((6, 8)) < 0.7
    return (
        (JCloud(jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(valid)),
         cloud_from_numpy({"xyz": xyz, "rgb": rgb, "valid": valid})),
        (JOrganized(jnp.asarray(org_xyz), jnp.asarray(org_rgb), jnp.asarray(org_valid)),
         cloud_from_numpy({"xyz": org_xyz, "rgb": org_rgb, "valid": org_valid},
                          organized=True)),
    )


@pytest.mark.parametrize("codec", ["native", "python"])
@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
@pytest.mark.parametrize("keep_invalid", [True, False])
def test_save_pcd_bytes_match_jax(tmp_path, monkeypatch, codec, mode, keep_invalid):
    if codec == "native":
        # both packages compress through the same native codec where it builds
        assert tnative.available() == jnative.available()
    else:
        # both packages' Python compressors
        monkeypatch.setattr(jnative, "lzf_compress", lambda data: None)
        monkeypatch.setattr(tnative, "lzf_compress", lambda data: None)
    for k, (jc, tc) in enumerate(_pcd_clouds()):
        a, b = tmp_path / f"jax{k}.pcd", tmp_path / f"port{k}.pcd"
        jpcd.save_pcd(a, jc, mode=mode, keep_invalid=keep_invalid)
        tpcd.save_pcd(b, tc, mode=mode, keep_invalid=keep_invalid)
        assert b.read_bytes() == a.read_bytes()


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
def test_load_pcd_round_trips(tmp_path, mode):
    for k, (jc, tc) in enumerate(_pcd_clouds()):
        path = tmp_path / f"c{k}.pcd"
        tpcd.save_pcd(path, tc, mode=mode, keep_invalid=False)
        back = tpcd.load_pcd(path, device="cpu")
        assert type(back) is type(tc)
        v = tc.valid.numpy()
        if k == 0:  # unorganized: only the valid points were written
            assert bool(back.valid.all())
            np.testing.assert_array_equal(back.xyz.numpy(), tc.xyz.numpy()[v])
            np.testing.assert_array_equal(back.rgb.numpy(), tc.rgb.numpy()[v])
        else:  # organized: the whole grid, invalid pixels as NaN
            np.testing.assert_array_equal(back.valid.numpy(), v)
            np.testing.assert_array_equal(back.xyz.numpy()[v], tc.xyz.numpy()[v])
            np.testing.assert_array_equal(back.rgb.numpy(), tc.rgb.numpy())
        # and the JAX package reads the port's file (its own native codec
        # where it has one)
        jb = jpcd.load_pcd(path)
        np.testing.assert_array_equal(np.asarray(jb.valid), back.valid.numpy())
