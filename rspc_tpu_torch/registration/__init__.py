"""Registration layer (port of ``rspc_tpu/registration``)."""
