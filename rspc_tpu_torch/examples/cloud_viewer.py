"""Standalone cloud viewer example.

The reference's examples/visualizer/cloudViewer.cpp: load a .pcd and
render it. The GL window becomes a headless render to PNG on the card
(the same camera model, ``viz/render.py``); YAW and PITCH stand for the
interactive drag state. The PNG is written to the working directory.

Usage: python -m rspc_tpu_torch.examples.cloud_viewer FILE.pcd [YAW] [PITCH]
"""

from __future__ import annotations

import os

from rspc_tpu_torch.examples._viewer_common import as_cloud, fit_to_view, revalidate_finite, run


def _main(args, device) -> int:
    from rspc_tpu_torch.io.pcd import load_pcd
    from rspc_tpu_torch.viz.render import ViewState, render_to_png

    path = args[1]
    yaw = float(args[2]) if len(args) > 2 else 0.0
    pitch = float(args[3]) if len(args) > 3 else 0.0
    # PCL CloudViewer semantics: every finite point, the camera fitted
    cloud = fit_to_view(revalidate_finite(as_cloud(load_pcd(path, device=device))))
    out = os.path.basename(path) + ".view.png"
    render_to_png(out, cloud, state=ViewState(yaw=yaw, pitch=pitch))
    print(f"rendered {out}")
    return 0


def main(argv=None, device="cuda") -> int:
    return run(_main, argv, __doc__, device)


if __name__ == "__main__":
    raise SystemExit(main())
