"""State estimators (port of ``rspc_tpu/estimators``)."""
