"""RGBD sources (port of ``rspc_tpu/capture``)."""
