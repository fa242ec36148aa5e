"""The port's headless renderer, PNG writer, native I/O, dataset directory
and profiling helpers against the JAX package (CPU).

Tolerances: PNG bytes, LZF bytes (each codec against its counterpart:
native with native, Python with Python), the dataset loads and the saved PCD
bytes are exact. The renderer equals the JAX package's image at every
pixel where at most one colour holds the minimum depth. Where several
points tie there, the port takes the lowest point index, and the JAX
package whichever its scatter keeps (on the CPU, measured: the highest
index). The tie pixels are those that change when the point order is
reversed: 270 and 277 of 57,600 in the seeded clouds below, and the
images differ at exactly those.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rspc_tpu.cloud import Cloud as JCloud
from rspc_tpu.cloud import OrganizedCloud as JOrganized
from rspc_tpu.io import dataset as j_dataset
from rspc_tpu.io import native as j_native
from rspc_tpu.io import pcd as j_pcd
from rspc_tpu.viz import png as j_png
from rspc_tpu.viz import render as j_render
from rspc_tpu_torch.cloud import Cloud, OrganizedCloud
from rspc_tpu_torch.io import dataset, native, pcd
from rspc_tpu_torch.utils import profiling
from rspc_tpu_torch.viz import png, render
from rspc_tpu_torch.viz.render import BG, ViewState, render_to_png


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores, where torch's spinning
    intra-op threads slow every worker down by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


W, H = 320, 180


def _points(seed, n=4000):
    """Points in front of the camera with integer colours; every 10th
    point repeats another's position and depth with a different colour,
    so some pixels hold ties."""
    rng = np.random.default_rng(seed)
    xyz = np.c_[rng.uniform(-1.2, 1.2, (n, 2)), rng.uniform(0.3, 4.0, n)].astype(np.float32)
    xyz[::10] = xyz[1::10][: len(xyz[::10])]
    rgb = rng.integers(0, 256, (n, 3)).astype(np.float32)
    valid = rng.random(n) < 0.95
    return xyz, rgb, valid


def _render(xyz, rgb, valid, **kw):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return render.render_cloud(t(xyz), t(rgb), t(valid), width=W, height=H, **kw).numpy()


def test_write_png_same_bytes(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (37, 53, 3)).astype(np.uint8)
    png.write_png(str(tmp_path / "a.png"), img)
    j_png.write_png(str(tmp_path / "b.png"), img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_render_cloud_matches_jax_apart_from_ties(seed):
    xyz, rgb, valid = _points(seed)
    want = np.asarray(j_render.render_cloud(
        jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(valid), jnp.float32(0.0),
        jnp.float32(0.0), jnp.float32(0.0), width=W, height=H))
    got = _render(xyz, rgb, valid)
    rev = _render(xyz[::-1], rgb[::-1], valid[::-1])
    ties = (got != rev).any(-1)
    assert 0 < ties.sum() <= len(xyz) // 10  # at most one per planted duplicate
    assert (got != BG).any(-1).sum() > 2000
    np.testing.assert_array_equal(got[~ties], want[~ties])


def test_render_tie_takes_the_lowest_point_index():
    xyz = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    rgb = np.array([[0, 255, 0], [255, 0, 0]], np.float32)
    valid = np.array([True, True])
    for order in ([0, 1], [1, 0]):
        img = _render(xyz[order], rgb[order], valid)
        ys, xs = np.where(~(img == BG).all(axis=-1))
        assert tuple(img[ys[0], xs[0]]) == tuple(rgb[order[0]].astype(np.uint8))


def test_render_tie_across_offset_passes():
    """At 1280 px points are 2x2. Two points at one depth in adjacent
    columns: the left point's second column covers the right point's
    first in another offset pass, and the lower index wins there too."""
    width, height = 1280, 720
    f = 1.0 / np.tan(np.radians(30.0))
    x = [((c + 0.5) / width * 2 - 1) * (width / height) / f for c in (100, 101)]
    xyz = np.array([[x[0], 0.0, 1.0], [x[1], 0.0, 1.0]], np.float32)
    rgb = np.array([[0, 255, 0], [255, 0, 0]], np.float32)
    valid = np.array([True, True])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    for order in ([0, 1], [1, 0]):
        img = render.render_cloud(t(xyz[order]), t(rgb[order]), t(valid),
                                  width=width, height=height).numpy()
        ys, xs = np.where(~(img == BG).all(axis=-1))
        assert sorted(set(xs)) == [100, 101, 102]
        for y in ys[xs == 101]:
            assert tuple(img[y, 101]) == tuple(rgb[order[0]].astype(np.uint8))


# the JAX package's renderer checks (tests/test_viz_cli.py), on the port

def test_render_cloud_draws_points(tmp_path):
    # a red point 1m ahead must land near the image center
    c = Cloud.from_numpy(np.array([[0.0, 0.0, 1.0]], np.float32),
                         np.array([[255.0, 0.0, 0.0]], np.float32), device="cpu")
    img = render_to_png(str(tmp_path / "r.png"), c, width=64, height=48)
    assert img.shape == (48, 64, 3)
    assert (img == BG).all(axis=-1).mean() > 0.99
    ys, xs = np.where(~(img == BG).all(axis=-1))
    assert len(ys) >= 1
    assert abs(xs[0] - 32) <= 1 and abs(ys[0] - 24) <= 1
    assert tuple(img[ys[0], xs[0]]) == (255, 0, 0)


def test_render_depth_test(tmp_path):
    # nearer point must win the z-buffer
    c = Cloud.from_numpy(np.array([[0, 0, 1.0], [0, 0, 2.0]], np.float32),
                         np.array([[0, 255, 0], [255, 0, 0]], np.float32), device="cpu")
    img = render_to_png(str(tmp_path / "z.png"), c, width=64, height=48)
    ys, xs = np.where(~(img == BG).all(axis=-1))
    assert tuple(img[ys[0], xs[0]]) == (0, 255, 0)


def test_render_yaw_moves_point(tmp_path):
    c = Cloud.from_numpy(np.array([[0.0, 0.0, 1.0]], np.float32),
                         np.array([[255.0, 255.0, 255.0]], np.float32), device="cpu")
    st = ViewState()
    st.drag(30.0, 0.0)  # yaw -30
    img = render_to_png(str(tmp_path / "y.png"), c, state=st, width=64, height=48)
    ys, xs = np.where(~(img == BG).all(axis=-1))
    assert len(xs) >= 1 and xs[0] != 32  # moved off center


def test_view_state_clamps():
    st = ViewState()
    st.drag(1000, -1000)
    assert st.yaw == -120 and st.pitch == -80
    st.reset()
    assert st.yaw == 0 and st.pitch == 0


def test_render_to_png_at_full_width_matches_jax(tmp_path):
    """1280x720 (two-pixel points, four z-buffer passes), an organized
    cloud, a yawed and pitched view: the same PNG bytes where no pixel
    ties."""
    rng = np.random.default_rng(2)
    xyz = np.concatenate([rng.uniform(-1.0, 1.0, (24, 32, 2)),
                          rng.uniform(0.5, 3.0, (24, 32, 1))], axis=-1).astype(np.float32)
    rgb = rng.integers(0, 256, (24, 32, 3)).astype(np.float32)
    st = ViewState()
    st.drag(-12.0, 7.0)
    st.scroll(0.0, 2.0)
    got = render_to_png(str(tmp_path / "a.png"),
                        OrganizedCloud.from_numpy(xyz, rgb, device="cpu"), state=st)
    j_st = j_render.ViewState(yaw=st.yaw, pitch=st.pitch, offset_y=st.offset_y)
    want = j_render.render_to_png(str(tmp_path / "b.png"), JOrganized.from_numpy(xyz, rgb),
                                  state=j_st)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


def test_lzf_same_bytes_as_jax():
    if not (native.available() and j_native.available()):
        pytest.skip("native library unavailable (no toolchain)")
    rng = np.random.default_rng(1)
    for blob in (rng.integers(0, 16, 50_000, dtype=np.uint8).tobytes(),
                 rng.normal(0, 1, 4096).astype(np.float32).tobytes(),
                 b"abcabcabd" * 999):
        comp = pcd._lzf_compress(blob)
        assert comp == j_pcd._lzf_compress(blob) == native.lzf_compress(blob)
        assert pcd._lzf_decompress(comp, len(blob)) == blob
        # the Python codec reads the native bytes, and the reverse; its own
        # bytes (which may differ from the native codec's) equal the JAX
        # package's Python codec's
        saved = [(m, m._lib, m._tried) for m in (native, j_native)]
        for m, _, _ in saved:
            m._lib, m._tried = None, True
        try:
            assert pcd._lzf_decompress(comp, len(blob)) == blob
            py = pcd._lzf_compress(blob)
            assert py == j_pcd._lzf_compress(blob)
        finally:
            for m, lib, tried in saved:
                m._lib, m._tried = lib, tried
        assert pcd._lzf_decompress(py, len(blob)) == blob


def _jax_dataset(ddir):
    """An organized cloud in each DATA mode and one unorganized cloud,
    written by the JAX package, with invalid points."""
    rng = np.random.default_rng(0)
    h, w = 12, 16
    for i, mode in enumerate(["ascii", "binary", "binary_compressed"]):
        xyz = rng.uniform(-2, 2, (h, w, 3)).astype(np.float32)
        rgb = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
        xyz[0, 0] = np.nan
        xyz[3, 3, 2] = 0.0
        j_pcd.save_pcd(j_dataset.dataset_path("mix", i, ddir), JOrganized.from_numpy(xyz, rgb),
                       mode=mode)
    xyz = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    j_pcd.save_pcd(j_dataset.dataset_path("mix", 3, ddir),
                   JCloud.from_numpy(xyz, rng.integers(0, 255, (50, 3)).astype(np.float32)))


def _assert_same(got, want):
    assert type(got).__name__ == type(want).__name__
    for name in ("xyz", "rgb", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("route", ["native", "fallback"])
def test_load_dataset_clouds_matches_jax(tmp_path, monkeypatch, route):
    ddir = str(tmp_path / "dataset")
    os.makedirs(ddir)
    _jax_dataset(ddir)
    if route == "native":
        if not (native.available() and j_native.available()):
            pytest.skip("native library unavailable (no toolchain)")
        want = j_dataset.load_dataset_clouds("mix", 4, ddir)
    else:
        monkeypatch.setattr(native, "load_dataset", lambda paths, cap: None)
        want = [j_pcd.load_pcd(j_dataset.dataset_path("mix", i, ddir)) for i in range(4)]
    got = dataset.load_dataset_clouds("mix", 4, ddir, device="cpu")
    assert len(got) == 4
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_save_dataset_clouds_and_output_path_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-2, 2, (6, 8, 3)).astype(np.float32)
    xyz[1, 2] = np.nan
    rgb = rng.integers(0, 255, (6, 8, 3)).astype(np.float32)
    pts = rng.uniform(-2, 2, (30, 3)).astype(np.float32)
    mine = [OrganizedCloud.from_numpy(xyz, rgb, device="cpu"), Cloud.from_numpy(pts, device="cpu")]
    theirs = [JOrganized.from_numpy(xyz, rgb), JCloud.from_numpy(pts)]
    for mode in ("binary", "binary_compressed", "ascii"):
        a, b = str(tmp_path / f"a-{mode}"), str(tmp_path / f"b-{mode}")
        dataset.save_dataset_clouds("s", mine, a, mode=mode)
        j_dataset.save_dataset_clouds("s", theirs, b, mode=mode)
        for i in range(2):
            assert (open(dataset.dataset_path("s", i, a), "rb").read()
                    == open(j_dataset.dataset_path("s", i, b), "rb").read())
    assert dataset.registration_output_path("t", "d") == j_dataset.registration_output_path("t", "d")
    assert dataset.registration_output_path("t") == os.path.join("dataset", "t-registration")
    assert dataset.dataset_path("p", 3) == j_dataset.dataset_path("p", 3)


def test_stage_timer_and_trace(tmp_path):
    timers = profiling.stage_timer()
    x = torch.ones(4)
    with timers("a", sync=x):
        x = x * 2
    with timers("a"):
        pass
    assert timers.counts == {"a": 2} and "a: " in timers.summary()
    profiling.device_sync({"x": x, "c": Cloud.from_numpy(np.ones((2, 3)), device="cpu")})
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
