"""Wall-clock seconds per phase of a command of the port, summed over the
run.  ``view``'s, for example: fasta (FASTA read into the host pool), pool
upload, K2, parse, batch (M-run column batch), pieces (piece table), upload
(piece table to the device), kernel (K1 and the counts' readback) and
format (stats, stat lines, output); ``chain``'s: parse, window, K6 (with
its upload and readback), extract and write; ``tile``'s: parse, walk
check, order, intervals, upload, K5 (with its readback) and, inside K5,
"K5 tiles" (the kernel's (tile, record) plan, built on the card), write.

Device phases end with a synchronize of the current stream, so each phase
holds its own device work; ``reset`` before a run and read ``SECONDS``
after it.  Threads add to ``SECONDS`` under a lock.  When several threads
run phases at once (``run_pipeline``'s worker threads, each on its own
stream), a phase's seconds are summed over the threads: busy time, which
can exceed the run's wall time, not wall time.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

SECONDS: dict[str, float] = {}

_lock = threading.Lock()


def reset() -> None:
    with _lock:
        SECONDS.clear()


@contextmanager
def timed(name: str, device=None):
    """Adds the wall time of the ``with`` body to ``SECONDS[name]``; with a
    CUDA ``device`` (a ``torch.device``), after a synchronize of this
    thread's current stream on it (not of the whole device, which would
    wait for other threads' streams too).  torch is imported only then, so
    that a host command never loads it."""
    t0 = time.perf_counter()
    yield
    if device is not None and device.type == "cuda":
        import torch
        torch.cuda.current_stream(device).synchronize()
    dt = time.perf_counter() - t0
    with _lock:
        SECONDS[name] = SECONDS.get(name, 0.0) + dt
