"""Geometry and image operators (port of ``rspc_tpu/ops``)."""
