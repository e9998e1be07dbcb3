"""Structured logging: the port's copy of zeronotesamba_tpu/utils/logging.py.

Its loggers hang under ``zns_torch``, so a process that imports both
packages does not print each line twice."""

from __future__ import annotations

import logging
import sys

_CONFIGURED = False


def get_logger(name: str = "zns_torch") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"))
        root = logging.getLogger("zns_torch")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(f"zns_torch.{name}")
