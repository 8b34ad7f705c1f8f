"""Leveled logging (the JAX package's ``utils/logging.py``) — analog of the
reference's ``_INFO/_WARN/_ERROR`` with a global dump level
(src/Utils/GST_log.hpp:42-66)."""
from __future__ import annotations

import logging
import sys

_FMT = "[%(levelname).1s %(asctime)s %(name)s] %(message)s"
_configured = False


def get_logger(name: str = "koifish") -> logging.Logger:
    """A logger under ``koifish``; the first call gives ``koifish`` its
    stderr handler at level INFO (not propagated to the root logger)."""
    global _configured
    if not _configured:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        root = logging.getLogger("koifish")
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    return logging.getLogger(name)


def set_level(level: str) -> None:
    """The ``koifish`` loggers' level by name ("debug", "INFO", ...)."""
    logging.getLogger("koifish").setLevel(level.upper())
