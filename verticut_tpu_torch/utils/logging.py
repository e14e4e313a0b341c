"""Leveled logger with pid + microsecond timestamps — the IBConnManager
logger analog (``Pilaf/ibman.cc:231-243``, levels ``ibman.h:15-21``:
VITAL always prints, then ERROR/WARN/INFO/DEBUG gated by verbosity).
The port's copy of ``verticut_tpu/utils/logging.py``."""

from __future__ import annotations

import logging
import os
import sys

_FMT = "[%(process)d %(asctime)s.%(msecs)03d %(levelname).1s %(name)s] %(message)s"
_DATEFMT = "%H:%M:%S"

VITAL = logging.CRITICAL  # always printed


def get_logger(name: str = "verticut") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT, datefmt=_DATEFMT))
        logger.addHandler(h)
        level = os.environ.get("VERTICUT_LOG", "INFO").upper()
        logger.setLevel(getattr(logging, level, logging.INFO))
        logger.propagate = False
    return logger
