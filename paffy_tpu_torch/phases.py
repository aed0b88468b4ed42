"""Wall-clock seconds per phase of a command of the port, summed over the
run.  ``view``'s, for example: fasta (FASTA read into the host pool), pool
upload, K2, parse, batch (M-run column batch), pieces (piece table), upload
(piece table to the device), kernel (K1 and the counts' readback) and
format (stats, stat lines, output); ``chain``'s: parse, window, K6 (with
its upload and readback), extract and write; ``tile``'s: parse, walk
check, order, intervals, upload, K5 (with its readback) and, inside K5,
"K5 tiles" (the kernel's (tile, record) plan, built on the card), write.

Device phases end with a synchronize, so each phase holds its own device
work; ``reset`` before a run and read ``SECONDS`` after it.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

SECONDS: dict[str, float] = {}


def reset() -> None:
    SECONDS.clear()


@contextmanager
def timed(name: str, device=None):
    """Adds the wall time of the ``with`` body to ``SECONDS[name]``; with a
    CUDA ``device`` (a ``torch.device``), after a synchronize.  torch is
    imported only then, so that a host command never loads it."""
    t0 = time.perf_counter()
    yield
    if device is not None and device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
    SECONDS[name] = SECONDS.get(name, 0.0) + time.perf_counter() - t0
