"""Standalone PCD visualization example.

The reference's examples/visualizer/pcdVisualization.cpp: load a .pcd,
estimate radius-search normals at two radii (0.05 and 0.1; computed and,
as in the reference, not used by the render) and display the cloud. The
PCLVisualizer window becomes a headless PNG render on the card, written
to the working directory.

Usage: python -m rspc_tpu_torch.examples.pcd_visualization FILE.pcd
"""

from __future__ import annotations

import os

from rspc_tpu_torch.examples._viewer_common import as_cloud, fit_to_view, revalidate_finite, run


def _main(args, device) -> int:
    from rspc_tpu_torch.io.pcd import load_pcd
    from rspc_tpu_torch.ops.normals import estimate_normals_radius
    from rspc_tpu_torch.viz.render import render_to_png

    path = args[1]
    # PCLVisualizer semantics: every finite point counts
    cloud = revalidate_finite(as_cloud(load_pcd(path, device=device)))
    # two NormalEstimation passes, results unused (pcdVisualization.cpp:51-60)
    _, ok1 = estimate_normals_radius(cloud, radius=0.05)
    _, ok2 = estimate_normals_radius(cloud, radius=0.1)
    print(f"normals: {int(ok1.sum())} valid @ r=0.05, {int(ok2.sum())} valid @ r=0.1 "
          f"(of {int(cloud.count())} points)")
    out = os.path.basename(path) + ".view.png"
    render_to_png(out, fit_to_view(cloud))
    print(f"rendered {out}")
    return 0


def main(argv=None, device="cuda") -> int:
    return run(_main, argv, __doc__, device)


if __name__ == "__main__":
    raise SystemExit(main())
