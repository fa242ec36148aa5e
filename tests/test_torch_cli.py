"""The port's command line (``rspc_tpu_torch.cli``) against the JAX
package's (CPU): each package runs in its own temporary directory on the
same 3-frame 80x60 replay recording (tests/test_capture_cli.py), the port
with ``device="cpu"``.

Tolerances: the captured PCD files and the ``--view`` PNG are the same
bytes; ``--registration`` reads back equal to the port's own API call;
``--all 3``'s global cloud is within 5e-3 m of the JAX CLI's (measured
9.2e-4: phase 1's NMS ties, PERF.md §6).
"""

import os

import numpy as np
import pytest
import torch

from rspc_tpu import cli as j_cli
from rspc_tpu.capture.replay import ReplaySource as JReplay
from rspc_tpu.capture.synthetic import SyntheticSequence as JSequence
from rspc_tpu.ops.deproject import Intrinsics as JIntrinsics
from rspc_tpu_torch import cli
from rspc_tpu_torch.capture.synthetic import SyntheticSequence
from rspc_tpu_torch.io.dataset import load_dataset_clouds, save_dataset_clouds
from rspc_tpu_torch.io.pcd import load_pcd
from rspc_tpu_torch.ops.deproject import Intrinsics
from rspc_tpu_torch.registration.schemes import NDTEdgeBasedRegistration


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run this module's PyTorch CPU ops on one thread: the suite runs
    several worker processes on few cores, where torch's spinning
    intra-op threads slow every worker down by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ALL_TOL = 5e-3


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    intr = JIntrinsics.simple(80, 60)
    seq = JSequence(n_frames=3, yaw_step=-0.07, intr=intr)
    depths, colors = zip(*[(np.asarray(d), np.asarray(c)) for d, c in seq.frames()])
    stream, snap = seq.imu_stream()
    path = str(tmp_path_factory.mktemp("rec") / "rec.npz")
    JReplay.save(path, np.stack(depths), np.stack(colors), np.asarray(stream.ts)[snap],
                 np.asarray(stream.data)[snap - 1], np.asarray(stream.data)[snap], intr)
    return path


def run(argv, **kw):
    return cli.main(["rspc-torch", *argv], device="cpu", **kw)


@pytest.fixture()
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("RSPC_PRESET", raising=False)
    return tmp_path


def test_help_and_unknown_option_return_1(in_tmp, capsys):
    assert run([]) == 1
    assert "Usage: rspc-torch" in capsys.readouterr().out
    assert run(["--help"]) == 1
    assert run(["--bogus"]) == 1
    assert run(["--view"]) == 1  # wrong argument count
    assert "Usage" in capsys.readouterr().out


def test_stoi_takes_the_integer_prefix():
    assert cli._stoi("-4.58") == -4
    assert cli._stoi("12abc") == 12
    assert cli._stoi(" +7") == 7
    with pytest.raises(ValueError):
        cli._stoi("abc")


def _files(d, prefix, n):
    return [(d / "dataset" / f"{prefix}-{i}.pcd").read_bytes() for i in range(n)]


def test_capture_runs_odometry_and_saves_the_jax_clis_clouds(recording, tmp_path, monkeypatch):
    """``--capture`` runs the odometry (match PNGs) and saves the same
    bytes as without it and as the JAX CLI (run without its odometry,
    which tests/test_capture_cli.py shows changes no byte)."""
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    port.mkdir(), jax_dir.mkdir()
    monkeypatch.chdir(port)
    monkeypatch.setenv("RSPC_CAPTURE_MATCH_DIR", str(port / "matches"))
    assert run(["--capture", "odo", "3", recording]) == 0
    assert (port / "matches" / "matches-1.png").exists()
    assert (port / "matches" / "matches-2.png").exists()
    monkeypatch.delenv("RSPC_CAPTURE_MATCH_DIR")
    monkeypatch.setenv("RSPC_CAPTURE_NO_ODOMETRY", "1")
    assert run(["--capture", "plain", "3", recording]) == 0
    monkeypatch.chdir(jax_dir)
    assert j_cli.main(["rspc", "--capture", "odo", "3", recording]) == 0
    assert _files(port, "odo", 3) == _files(port, "plain", 3) == _files(jax_dir, "odo", 3)


@pytest.fixture()
def captured(recording, in_tmp, monkeypatch):
    monkeypatch.setenv("RSPC_CAPTURE_NO_ODOMETRY", "1")
    assert run(["--capture", "cap", "3", recording]) == 0
    return in_tmp


def test_edges_and_view_write_their_pngs(captured, tmp_path_factory, monkeypatch):
    assert run(["--edges", "cap-0.pcd"]) == 0
    assert (captured / "dataset" / "cap-0.pcd.edges.png").stat().st_size > 0
    assert run(["--view", "cap-1"]) == 0
    png = (captured / "dataset" / "cap-1.pcd.png").read_bytes()
    # the JAX CLI renders the same file to the same bytes
    other = tmp_path_factory.mktemp("jax_view")
    os.makedirs(other / "dataset")
    (other / "dataset" / "cap-1.pcd").write_bytes(
        (captured / "dataset" / "cap-1.pcd").read_bytes())
    monkeypatch.chdir(other)
    assert j_cli.main(["rspc", "--view", "cap-1"]) == 0
    assert (other / "dataset" / "cap-1.pcd.png").read_bytes() == png


@pytest.mark.parametrize("args,rads", [(["-6.58", "2"], (-6 / 180.0) * np.pi),
                                       (["2"], None)])
def test_registration_writes_the_api_result(in_tmp, args, rads):
    """``--registration PREFIX [DEG] N``: ``t-registration`` without an
    extension (and its PNG), equal bit for bit to the scheme's own result."""
    seq = SyntheticSequence(n_frames=2, yaw_step=-0.1, intr=Intrinsics.simple(80, 60))
    save_dataset_clouds("t", seq.clouds(device="cpu"), "dataset")
    assert run(["--registration", "t", *args]) == 0
    assert os.path.exists("dataset/t-registration.png")
    assert not os.path.exists("dataset/t-registration.pcd")
    back = load_pcd("dataset/t-registration", device="cpu")
    want = NDTEdgeBasedRegistration(rads=rads).registration(
        load_dataset_clouds("t", 2, "dataset", device="cpu"))
    v = want.valid
    assert torch.equal(back.xyz, want.xyz[v])
    assert torch.equal(back.rgb, torch.trunc(want.rgb[v].clamp(0, 255)))


def test_all_matches_the_jax_cli(recording, tmp_path, monkeypatch):
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    port.mkdir(), jax_dir.mkdir()
    monkeypatch.chdir(port)
    assert run(["--all", "3", "out", recording]) == 0
    monkeypatch.chdir(jax_dir)
    assert j_cli.main(["rspc", "--all", "3", "out", recording]) == 0
    names = sorted(["out.pcd", "edge_cloud.pcd"] + [f"edge-{i}.pcd" for i in range(3)])
    assert sorted(os.listdir(port / "dataset")) == names
    got = load_pcd(str(port / "dataset" / "out.pcd"), device="cpu")
    want = load_pcd(str(jax_dir / "dataset" / "out.pcd"), device="cpu")
    assert got.xyz.shape == want.xyz.shape and got.xyz.shape[0] > 1000
    assert torch.equal(got.rgb, want.rgb)
    assert float((got.xyz - want.xyz).abs().max()) <= ALL_TOL


@pytest.mark.parametrize("preset", ["robust", "auto"])
def test_robust_and_auto_presets_name_the_roadmap(in_tmp, capsys, preset):
    assert run(["--registration", "t", "2", "--preset", preset]) == 1
    assert "ROADMAP.md Queue A step 4" in capsys.readouterr().err
    assert run(["--all", "3", "out", f"--preset={preset}"]) == 1
    assert "ROADMAP.md Queue A step 4" in capsys.readouterr().err
    assert not os.path.exists("dataset")


def test_preset_flag_parsing(in_tmp, monkeypatch):
    args, p = cli._extract_preset(["rspc-torch", "--registration", "t", "2"])
    assert p == "reference" and args == ["rspc-torch", "--registration", "t", "2"]
    args, p = cli._extract_preset(["rspc-torch", "--registration", "t", "2", "--preset", "auto"])
    assert p == "auto" and args == ["rspc-torch", "--registration", "t", "2"]
    args, p = cli._extract_preset(["rspc-torch", "--preset=robust", "--view", "x"])
    assert p == "robust" and args == ["rspc-torch", "--view", "x"]
    assert run(["--registration", "t", "2", "--preset", "bogus"]) == 1
    monkeypatch.setenv("RSPC_PRESET", "nope")
    assert run(["--view", "whatever"]) == 1


def test_edges_and_registration_go_interactive_on_a_tty(in_tmp, monkeypatch):
    import rspc_tpu_torch.viz.interactive as vi

    calls = []
    monkeypatch.setattr(vi, "interactive_view",
                        lambda cloud, png_path=None, **kw: calls.append(png_path))
    monkeypatch.setattr("sys.stdin.isatty", lambda: True)
    seq = SyntheticSequence(n_frames=2, yaw_step=-0.1, intr=Intrinsics.simple(80, 60))
    save_dataset_clouds("tty", seq.clouds(device="cpu"), "dataset")
    assert run(["--edges", "tty-0.pcd"]) == 0
    assert calls == ["dataset/tty-0.pcd.edges.png"]
    assert run(["--registration", "tty", "-6", "2"]) == 0
    assert calls[-1] == "dataset/tty-registration.png"
    assert run(["--view", "tty-1"]) == 0
    assert calls[-1] == "dataset/tty-1.pcd.png"


def test_the_default_device_needs_a_card(recording, in_tmp, capsys):
    """Without a card the default run exits 1 with the reason; it never
    carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works here")
    assert cli.main(["rspc-torch", "--capture", "x", "2", recording]) == 1
    assert capsys.readouterr().err.strip()
    assert not os.path.exists("dataset")
