"""Measurement tools of the port (``python -m rspc_tpu_torch.tools.NAME``)."""
