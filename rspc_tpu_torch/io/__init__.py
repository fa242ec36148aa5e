"""Point-cloud file I/O (port of ``rspc_tpu/io``)."""
