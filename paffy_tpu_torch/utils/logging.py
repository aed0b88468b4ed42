"""Leveled logging with the reference's sonLib logger semantics
(counterpart of paffy_tpu/utils/logging.py, without its JAX profiler hook).

A process-wide level set from the --logLevel flag (off, critical, info,
debug; critical by default); messages go to stderr.
"""

from __future__ import annotations

import logging
import sys
import time

_LEVELS = {
    None: logging.CRITICAL,
    "off": logging.CRITICAL + 10,
    "critical": logging.CRITICAL,
    "info": logging.INFO,
    "debug": logging.DEBUG,
}

logger = logging.getLogger("paffy_tpu_torch")
_handler = logging.StreamHandler(sys.stderr)
_handler.setFormatter(logging.Formatter("%(message)s"))
logger.addHandler(_handler)
logger.setLevel(logging.CRITICAL)


def set_log_level_from_string(level: str | None) -> None:
    key = level.lower() if isinstance(level, str) else level
    if key not in _LEVELS:
        raise ValueError(f"Unrecognised log level: {level}")
    logger.setLevel(_LEVELS[key])


def log_info(msg: str, *args) -> None:
    logger.info(msg, *args)


class CommandTimer:
    """The reference's '<tool> is done!, N seconds have elapsed' line."""

    def __init__(self, name: str):
        self.name = name
        self.start = time.time()

    def done(self) -> None:
        log_info("%s is done!, %d seconds have elapsed",
                 self.name, int(time.time() - self.start))
