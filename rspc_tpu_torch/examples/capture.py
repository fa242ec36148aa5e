"""Standalone capture example.

The reference's examples/capture/capture.cpp: configure a source, grab
one frameset, convert it to a full-resolution coloured cloud and save it
as ASCII PCD under ``samples/`` (the reference saves to
``../samples/<name>`` with savePCDFileASCII, capture.cpp:120).

Usage: python -m rspc_tpu_torch.examples.capture OUT_NAME [SOURCE.npz]
(SOURCE defaults to the synthetic room scene at 640x480, rendered on the
card.)
"""

from __future__ import annotations

import os

import numpy as np

from rspc_tpu_torch.examples._viewer_common import run


def _synthetic_source(device):
    from rspc_tpu_torch.capture.replay import ReplaySource
    from rspc_tpu_torch.capture.synthetic import SyntheticSequence
    from rspc_tpu_torch.ops.deproject import Intrinsics

    # the reference example uses 640x480 streams (capture.cpp:90-92)
    seq = SyntheticSequence(n_frames=1, intr=Intrinsics.simple(640, 480))
    depth, color = next(seq.frames(device))
    stream, snap = seq.imu_stream(device)
    ts, data = stream.ts.cpu().numpy(), stream.data.cpu().numpy()
    i = seq.intr
    return ReplaySource({
        "depth": depth.cpu().numpy()[None],
        "color": color.cpu().numpy()[None],
        "ts": ts[snap][:1],
        "gyro": data[snap - 1][:1],
        "accel": data[snap][:1],
        "intr": np.asarray([i.width, i.height, i.fx, i.fy, i.ppx, i.ppy], np.float32),
    })


def _main(args, device) -> int:
    from rspc_tpu_torch.capture.replay import ReplaySource, get_clouds
    from rspc_tpu_torch.config import CaptureConfig
    from rspc_tpu_torch.io.pcd import save_pcd

    out_name = args[1]
    src = _synthetic_source(device) if len(args) < 3 else ReplaySource(args[2])
    clouds, _ = get_clouds(src, 1, CaptureConfig(center_crop=False, bgr_color=False),
                           device=device)
    os.makedirs("samples", exist_ok=True)
    out = os.path.join("samples", out_name)
    save_pcd(out, clouds[0], mode="ascii")
    print(f"saved {out}")
    return 0


def main(argv=None, device="cuda") -> int:
    return run(_main, argv, __doc__, device)


if __name__ == "__main__":
    raise SystemExit(main())
