"""Leveled logging with the reference's sonLib logger semantics, and the
profiler hook (counterpart of paffy_tpu/utils/logging.py).

A process-wide level set from the --logLevel flag (off, critical, info,
debug; critical by default); messages go to stderr.

``PAFFY_TPU_PROFILE=<dir>`` wraps each command, from its ``CommandTimer``
to ``done()``, in a ``torch.profiler`` run: CPU activity, and CUDA
activity when the command's platform is a card (``PAFFY_TPU_PLATFORM``
unset, ``cuda`` or ``gpu``, and a CUDA device present), of every thread
where the installed torch offers it (``profile_all_threads``), so that
``run_pipeline``'s worker threads' spans are in it too.  One Chrome trace
per command is written into <dir>, named after the command and the
process id; it holds the command's phases and spans (phases.py) as
``user_annotation`` events.  Without the variable the profiler is neither
imported nor started.
"""

from __future__ import annotations

import logging
import os
import sys
import time

_LEVELS = {
    None: logging.CRITICAL,
    "off": logging.CRITICAL + 10,
    "critical": logging.CRITICAL,
    "info": logging.INFO,
    "debug": logging.DEBUG,
}

PROFILE_ENV = "PAFFY_TPU_PROFILE"

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


def get_log_level() -> int:
    return logger.level


def log_info(msg: str, *args) -> None:
    logger.info(msg, *args)


def log_debug(msg: str, *args) -> None:
    logger.debug(msg, *args)


def log_critical(msg: str, *args) -> None:
    logger.critical(msg, *args)


def debug_enabled() -> bool:
    return logger.isEnabledFor(logging.DEBUG)


def _start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    plat = os.environ.get("PAFFY_TPU_PLATFORM", "").strip().lower()
    if plat in ("", "cuda", "gpu") and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        every_thread = {"experimental_config": torch._C._profiler.
                        _ExperimentalConfig(profile_all_threads=True)}
    except (AttributeError, TypeError):     # a torch without the option
        every_thread = {}
    prof = profile(activities=activities, **every_thread)
    prof.start()
    return prof


_running_profilers: list = []


def stop_profilers() -> None:
    """Stop the profiler of a command that failed, without a trace: torch
    ends a process whose profiler still runs with a segmentation fault,
    where the command's own exit code belongs."""
    while _running_profilers:
        _running_profilers.pop().stop()


class CommandTimer:
    """The reference's '<tool> is done!, N seconds have elapsed' line, and
    the command's profiler run under PAFFY_TPU_PROFILE."""

    def __init__(self, name: str):
        self.name = name
        self.start = time.time()
        self._trace_dir = os.environ.get(PROFILE_ENV)
        self._prof = _start_profiler() if self._trace_dir else None
        if self._prof is not None:
            _running_profilers.append(self._prof)

    def done(self) -> None:
        if self._prof is not None:
            _running_profilers.remove(self._prof)
            self._prof.stop()
            os.makedirs(self._trace_dir, exist_ok=True)
            stem = "_".join(self.name.lower().split())
            path = os.path.join(self._trace_dir,
                                f"{stem}.{os.getpid()}.pt.trace.json")
            self._prof.export_chrome_trace(path)
            log_info("profiler trace written to %s", path)
        log_info("%s is done!, %d seconds have elapsed",
                 self.name, int(time.time() - self.start))
