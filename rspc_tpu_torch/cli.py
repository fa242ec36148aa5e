"""Command line of the port, the reference's ``rs-pcl`` binary (port of
``rspc_tpu/cli.py``; installed as ``rspc-torch``).

The option grammar, the positional-argument counts and the dataset
directory follow src/main.cpp:185-237:
  * ``--registration PREFIX N`` (4 arguments) runs the NDT edge scheme
    with the default -30 deg accumulated guess; ``--registration PREFIX
    DEG N`` (5 arguments) converts degrees by (deg/180)*pi
    (main.cpp:204-221); numbers parse as ``std::stoi`` does;
  * ``--edges FILE`` loads ``dataset/FILE`` (FILE includes .pcd, main.cpp:58-74);
  * ``--view NAME`` loads ``dataset/NAME.pcd`` (main.cpp:101-115);
  * the registration output has no ``.pcd`` extension (main.cpp:87);
  * no arguments or an unknown option print the help and exit 1.

Where the hardware differs: capture takes an optional trailing SOURCE (a
replay ``.npz`` or ``synthetic``), since no RealSense camera attaches to
the card's host; the GLFW render loop becomes the terminal viewer on a
TTY and a headless render to ``<output>.png`` otherwise (viz/render.py).

Everything runs on the card: ``main(argv, device="cuda")``. Without a
card the commands fail with the reason and exit 1; they never carry on
on the CPU unless the caller passes ``device="cpu"``, as the tests do.
"""

from __future__ import annotations

import os
import re
import sys
from typing import List, Optional

import numpy as np

DATASET = "dataset"
PRESETS = ("reference", "robust", "auto")


def _source(arg: Optional[str], frames: int, device):
    """A capture source: a replay npz path, or the synthetic scene
    (640x480, yaw step -0.15 rad) rendered on ``device``."""
    from rspc_tpu_torch.capture.replay import ReplaySource

    if arg is not None and arg != "synthetic":
        return ReplaySource(arg)
    from rspc_tpu_torch.capture.synthetic import SyntheticSequence
    from rspc_tpu_torch.ops.deproject import Intrinsics

    seq = SyntheticSequence(n_frames=frames, yaw_step=-0.15, intr=Intrinsics.simple(640, 480))
    depths, colors = zip(*[(d.cpu().numpy(), c.cpu().numpy()) for d, c in seq.frames(device)])
    stream, snap = seq.imu_stream(device)
    ts, data = stream.ts.cpu().numpy(), stream.data.cpu().numpy()
    i = seq.intr
    return ReplaySource({
        "depth": np.stack(depths),
        "color": np.stack(colors),
        "ts": ts[snap],
        "gyro": data[snap - 1],
        "accel": data[snap],
        "intr": np.asarray([i.width, i.height, i.fx, i.fy, i.ppx, i.ppy], np.float32),
    })


def capture(prefix: str, frames: int, source_arg: Optional[str] = None, device="cuda") -> None:
    """``--capture``: the reference's v2 capture path (main.cpp:37-56 ->
    get_clouds_new, capture_opencv.hpp:239-358): full-resolution clouds
    and the SIFT visual odometry, whose poses the caller drops
    (main.cpp:44-53); the clouds go to dataset/{prefix}-{i}.pcd.

    ``RSPC_CAPTURE_NO_ODOMETRY=1`` skips the odometry (the saved clouds
    are the same either way); ``RSPC_CAPTURE_MATCH_DIR=DIR`` writes
    ``matches-{i}.png`` per pair (the reference's drawMatches ->
    matches.jpg, capture_opencv.hpp:74-79)."""
    from rspc_tpu_torch.config import CaptureConfig
    from rspc_tpu_torch.io.dataset import save_dataset_clouds

    src = _source(source_arg, frames, device)
    cfg = CaptureConfig(center_crop=False, bgr_color=False)  # v2: full res
    if os.environ.get("RSPC_CAPTURE_NO_ODOMETRY"):
        from rspc_tpu_torch.capture.replay import get_clouds

        clouds, _thetas = get_clouds(src, frames, cfg, device=device)
    else:
        from rspc_tpu_torch.capture.odometry import get_clouds_new

        pairs = get_clouds_new(
            src, frames, config=cfg,
            debug_dir=os.environ.get("RSPC_CAPTURE_MATCH_DIR") or None,
            device=device,
        )
        clouds = [c for c, _pose in pairs]  # poses dropped, like the reference
    if len(clouds) < frames:
        print(f"[RS]  only captured {len(clouds)}/{frames} frames", file=sys.stderr)
    save_dataset_clouds(prefix, clouds, DATASET)
    for i in range(len(clouds)):
        print(f"[RS]    Saved {DATASET}/{prefix}-{i}.pcd")


def _view_or_png(cloud, png_path: str, what: str) -> None:
    """End a command in a render, like the reference's live GL loop
    (``--edges`` main.cpp:70-73, ``--registration`` main.cpp:96-98): the
    interactive terminal viewer on a TTY, else a PNG with the same camera."""
    if sys.stdin.isatty():
        from rspc_tpu_torch.viz.interactive import interactive_view

        interactive_view(cloud, png_path=png_path)
    else:
        from rspc_tpu_torch.viz.render import render_to_png

        render_to_png(png_path, cloud)
    print(f"[PCL] {what} saved to {png_path}")


def edges(filename: str, device="cuda") -> None:
    """``--edges``: RGB-edge features of dataset/FILE, ended in the
    render loop (main.cpp:58-74)."""
    from rspc_tpu_torch.cloud import OrganizedCloud
    from rspc_tpu_torch.io.pcd import load_pcd
    from rspc_tpu_torch.ops.edges import extract_edge_features

    cloud = load_pcd(os.path.join(DATASET, filename), device=device)
    if not isinstance(cloud, OrganizedCloud):
        print("error: edge extraction requires an organized cloud", file=sys.stderr)
        raise SystemExit(1)
    result = extract_edge_features(cloud)
    _view_or_png(result, os.path.join(DATASET, filename + ".edges.png"), "Edge render")


def _extract_preset(args: List[str]) -> tuple:
    """Strip ``--preset NAME`` / ``--preset=NAME`` (or the ``RSPC_PRESET``
    variable) before the argc-dependent dispatch, so the reference's
    positional grammar (main.cpp:185-237) is untouched without it."""
    preset = os.environ.get("RSPC_PRESET", "reference")
    out = []
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--preset":
            if i + 1 >= len(args):
                raise ValueError("--preset requires a value " + str(PRESETS))
            preset = args[i + 1]
            i += 2
            continue
        if a.startswith("--preset="):
            preset = a.split("=", 1)[1]
            i += 1
            continue
        out.append(a)
        i += 1
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; choose from {PRESETS}")
    return out, preset


class _AutoScheme:
    """``auto_register`` behind the ``registration(clouds)`` surface the
    commands call (types.hpp:14-20 analog), so ``--preset auto`` fits the
    reference grammar."""

    def __init__(self, rads=None, thetas=None):
        self.rads, self.thetas = rads, thetas
        self.result = None

    def registration(self, clouds):
        from rspc_tpu_torch.registration.auto import auto_register

        ar = auto_register(clouds, thetas=self.thetas, rads=self.rads)
        self.result = ar
        print(f"[PCL] auto preset: selected '{ar.selected}' "
              f"(closures={ar.closures}, texture={ar.texture:.4f})")
        return ar.global_cloud


def _registration_scheme(preset: str, rads=None, thetas=None):
    """The NDT edge scheme of ``--registration`` under ``preset``
    (reference default: main.cpp:208,218): ``reference`` the default
    config, ``robust`` ``robust_config(anchor_mode="map")``, ``auto``
    :class:`_AutoScheme`."""
    from rspc_tpu_torch.registration.schemes import NDTEdgeBasedRegistration

    kw = {"thetas": thetas} if thetas is not None else {"rads": rads}
    if preset == "reference":
        return NDTEdgeBasedRegistration(**kw)
    if preset == "robust":
        from rspc_tpu_torch.presets import robust_config

        return NDTEdgeBasedRegistration(config=robust_config(anchor_mode="map"), **kw)
    return _AutoScheme(rads=rads, thetas=thetas)


def registration(prefix: str, scheme, frames: int, device="cuda") -> None:
    """``--registration`` (main.cpp:76-99): load dataset/{prefix}-{i}.pcd,
    run ``scheme``, save dataset/{prefix}-registration (no extension)
    and render."""
    from rspc_tpu_torch.io.dataset import load_dataset_clouds, registration_output_path
    from rspc_tpu_torch.io.pcd import save_pcd

    clouds = load_dataset_clouds(prefix, frames, DATASET, device=device)
    result = scheme.registration(clouds)
    out = registration_output_path(prefix, DATASET)
    save_pcd(out, result, keep_invalid=False)
    print(f"[PCL] Saved {out}")
    _view_or_png(result, out + ".png", "Render")


def viewer(name: str, device="cuda") -> None:
    """``--view``: view dataset/{name}.pcd (main.cpp:101-115), in the
    interactive terminal viewer on a TTY (visualizer.hpp:24-53), else as
    one PNG."""
    from rspc_tpu_torch.io.pcd import load_pcd

    path = os.path.join(DATASET, name + ".pcd")
    _view_or_png(load_pcd(path, device=device), path + ".png", "Render")


def capture_and_registration(frames: int, icp_based_filename: str,
                             source_arg: Optional[str] = None, preset: str = "reference",
                             device="cuda") -> None:
    """``--all``: capture and ICP-edge registration with IMU thetas
    (main.cpp:117-134); the edge scheme writes its edge PCDs into
    dataset/, the global cloud goes to dataset/{file}.pcd. Under another
    ``preset`` the robust NDT stack or the auto selection takes the ICP
    scheme's place, with the same thetas (and no edge PCDs)."""
    from rspc_tpu_torch.capture.replay import get_clouds
    from rspc_tpu_torch.io.pcd import save_pcd
    from rspc_tpu_torch.registration.schemes import ICPEdgeBasedRegistration

    src = _source(source_arg, frames, device)
    clouds, thetas = get_clouds(src, frames, device=device)
    if preset == "reference":
        scheme = ICPEdgeBasedRegistration(thetas=thetas, dataset_dir=DATASET)
    else:
        scheme = _registration_scheme(preset, thetas=thetas)
    result = scheme.registration(clouds)
    os.makedirs(DATASET, exist_ok=True)
    out = os.path.join(DATASET, icp_based_filename + ".pcd")
    save_pcd(out, result, keep_invalid=False)
    print(f"[PCL] Saved {out}")


HELP = """Usage: rspc-torch [OPTION] NR_CLOUDS...
Capture, perform registration, or do both for NR_CLOUDS time.
Example: rspc-torch --all 4

Options:
  --all NR_CLOUDS FILENAME [SOURCE]
      capture and perform registration for NR_CLOUDS time
      using dynamic rotation estimation from the (replayed) IMU.
  --capture FILENAME NR_CLOUDS [SOURCE]
      capture clouds for NR_CLOUDS time and save them to
      dataset/${FILENAME}-${CLOUD_IDX}.pcd
  --edges FILENAME
      extract edges from a pointcloud saved at dataset/${FILENAME}
  --registration FILENAME [ROTATION_DEG] NR_CLOUDS
      perform registration on files named dataset/${FILENAME}-${CLOUD_IDX}.pcd
      using estimated rotation degree of ROTATION_DEG as initial guesses.
      Default ROTATION_DEG: -30 degrees
  --view FILENAME
      render pointcloud saved at dataset/${FILENAME}.pcd
  --help
      print this help

SOURCE is an optional replay recording (.npz) or 'synthetic' (default):
no camera attaches to the card's host; see rspc_tpu_torch.capture.replay
for the recording format. Everything runs on the CUDA card.

Beyond the reference (opt-in; the default matches the reference binary):
  --preset {reference|robust|auto}   (or env RSPC_PRESET=...)
      registration stack for --registration / --all: 'robust' enables
      warm start + rescue + progressive map anchoring; 'auto' measures a
      candidate ladder on the trajectory and keeps the simplest winner."""


def _stoi(s: str) -> int:
    """C++ ``std::stoi``: the longest valid integer prefix ("-4.58" -> -4,
    "12abc" -> 12); raises only when no digit leads (src/main.cpp:196,215)."""
    m = re.match(r"[+-]?\d+", s.strip())
    if not m:
        raise ValueError(f"stoi: no conversion from {s!r}")
    return int(m.group(0))


def main(argv: Optional[List[str]] = None, device="cuda") -> int:
    """Run one command on ``device``. Errors print ``Type: message`` to
    stderr and return 1, the reference's two catch blocks (rs2::error /
    std::exception, main.cpp:238-244)."""
    try:
        return _dispatch(argv, device)
    except KeyboardInterrupt:
        raise
    except Exception as e:  # noqa: BLE001 -- the reference catches all
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1


def _dispatch(argv: Optional[List[str]], device) -> int:
    args = list(sys.argv if argv is None else argv)
    args, preset = _extract_preset(args)
    argc = len(args)

    if argc == 1:
        print(HELP)
        return 1
    opt = args[1]

    if opt == "--capture" and argc in (4, 5):
        capture(args[2], _stoi(args[3]), args[4] if argc == 5 else None, device)
        return 0
    if opt == "--edges" and argc == 3:
        edges(args[2], device)
        return 0
    if opt == "--registration" and argc in (4, 5):
        rads = None if argc == 4 else (_stoi(args[3]) / 180.0) * np.pi  # main.cpp:215
        registration(args[2], _registration_scheme(preset, rads=rads), _stoi(args[-1]),
                     device)
        return 0
    if opt == "--view" and argc == 3:
        viewer(args[2], device)
        return 0
    if opt == "--all" and argc in (4, 5):
        capture_and_registration(_stoi(args[2]), args[3], args[4] if argc == 5 else None,
                                 preset, device)
        return 0

    print(HELP)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
