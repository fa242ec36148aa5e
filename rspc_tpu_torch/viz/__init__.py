"""Headless rendering and PNG output (port of ``rspc_tpu/viz``)."""

from rspc_tpu_torch.viz.render import ViewState, render_cloud, render_to_png  # noqa: F401
