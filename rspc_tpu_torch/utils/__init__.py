"""Logging and the tracer (port of ``rspc_tpu/utils``)."""

from rspc_tpu_torch.utils.log import get_logger  # noqa: F401
from rspc_tpu_torch.utils.profiling import trace  # noqa: F401
