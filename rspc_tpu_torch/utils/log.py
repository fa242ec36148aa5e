"""Logging: structured replacement for the reference's [RS]/[PCL] prints
(SURVEY.md §5 'Metrics / logging / observability: stdout only')."""

from __future__ import annotations

import logging
import sys

_FORMAT = "[%(name)s] %(levelname)s %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("rspc")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        _configured = True
    return logging.getLogger(f"rspc.{name}")
