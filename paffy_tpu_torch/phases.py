"""Phases and spans of the port's commands: wall seconds per phase, summed
over a run, and, while a ``torch.profiler`` run is active, each phase as a
span with its parent and counters.

``timed(name)`` is a phase: the ``with`` body's wall seconds are added to
``SECONDS[name]``, whether tracing is on or off.  ``reset`` before a run and
read ``SECONDS`` after it.  Device phases (``timed(name, device)``) end
with a synchronize of the current stream, so each holds its own device
work.  Threads add to ``SECONDS`` under a lock; when several threads run
phases at once (``run_pipeline``'s worker threads, each on its own
stream), a phase's seconds are summed over the threads: busy time, which
can exceed the run's wall time.  No phase nests inside another of its own
name, so a name's seconds count each second once.

Tracing is on while a ``torch.profiler`` run is active in the process (a
benchmark's traced jobs, or a command under ``PAFFY_TPU_PROFILE``); torch
is consulted only when it is already loaded, so a host command never
imports it.  While tracing is on, every phase, and every ``span(name,
**ids)`` (structure only, not summed: ``run_pipeline`` around the call,
``group`` around each contig group's stage with ``group``, ``records``
and ``length`` as its identifiers), is appended to ``SPANS`` as a ``Span``: its name,
start and end on ``time.perf_counter`` (the clock the benchmark times its
jobs with), its parent (the enclosing span on its thread, or for a worker
thread the span its caller handed it, ``handoff``/``adopt``), its thread
and its counters.  Each also opens a ``torch.profiler.record_function`` of
its name, so the profiler's trace names the host's phases on the clock of
the card's kernels and copies.  Every span of a contig group descends from
its ``group`` span; under ``PAFFY_TPU_PROFILE`` the trace holds the worker
threads' spans too.

Counters (``count``) go to the innermost open span of the thread, only
while tracing is on:

  * ``wait_s``, ``waits``: host seconds and number of blocking waits on
    the card: a device phase's closing synchronize (timed apart from its
    body) and ``devconf.download``, ``to_host_i64`` and ``readback`` (K5's
    plan readbacks among them);
  * ``bytes_up``, ``bytes_down``: bytes across the link in
    ``devconf.upload`` and in those readbacks, on CUDA only;
  * ``groups``, ``workers``: on ``run_pipeline``'s span, the call's
    contig groups and the threads that ran them (1 when inline);
  * ``batches``, ``hist_mb``, ``carried_mb``: on K5's plan, the phase "K5
    tiles", its launch pairs, its histogram rows' MB and the MB of counts
    carried between its batches (ops/tile_device.TilePlan.counts); each
    batch's launches are a span "K5 batch" (``batch``, ``records``,
    ``bins``).

``reset`` clears ``SECONDS`` and leaves ``SPANS``: a reader takes the
spans between its own marks on the same clock.  A block that raises adds
neither seconds nor a span.  With tracing off a phase costs one look at a
thread-local flag and torch's profiler flag beyond its timing: no
``record_function``, no span, no synchronize of its own, no device
allocation.
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager

SECONDS: dict[str, float] = {}
SPANS: list["Span"] = []

_lock = threading.Lock()


class _Thread(threading.local):
    """Per thread: ``stack``, the open spans (a worker's first is its
    caller's); ``on``, the tracing state a worker was handed (None: ask
    torch)."""
    on = None
    stack = None


_local = _Thread()


class Span:
    """One traced phase (``phase`` True, summed into ``SECONDS``) or
    structural span, with ``ids`` (e.g. ``group``, ``records``) and
    ``counts`` (``wait_s``, ``waits``, ``bytes_up``, ``bytes_down``)."""

    __slots__ = ("name", "phase", "start", "end", "parent", "thread",
                 "counts", "ids")

    def __init__(self, name: str, phase: bool, parent: "Span | None",
                 ids: dict):
        self.name, self.phase, self.parent, self.ids = name, phase, parent, ids
        self.thread = threading.get_ident()
        self.counts: dict = {}
        self.start = self.end = 0.0

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.end - self.start:.6f} s, "
                f"ids={self.ids}, counts={self.counts})")


def reset() -> None:
    with _lock:
        SECONDS.clear()


def tracing() -> bool:
    """Whether phases on this thread record spans: a worker's handed state,
    else whether a torch.profiler run is active (never importing torch)."""
    if _local.on is not None:
        return _local.on
    # torch's own flag of the process, set by every profiler run (its
    # per-thread flag reads False on every thread under profile_all_threads)
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def recording() -> bool:
    """Whether a span is open on this thread to take counters."""
    return bool(_local.stack)


def count(**counts) -> None:
    """Adds ``counts`` to the innermost open span of this thread (nothing
    when none is open)."""
    stack = _local.stack
    if stack:
        _add(stack[-1], counts)


def _add(s: Span, counts: dict) -> None:
    with _lock:             # a worker's first span is its caller's
        for k, v in counts.items():
            s.counts[k] = s.counts.get(k, 0) + v


def handoff() -> list | None:
    """This thread's tracing state for a worker thread (``adopt``): None
    when off, else the worker's first open spans: this thread's innermost,
    which parents the worker's spans (none when none is open)."""
    if not tracing():
        return None
    return (_local.stack or [])[-1:]


def adopt(state: list | None) -> None:
    """In a worker thread's initializer: trace as the caller that made
    ``state`` (``handoff``) does, under its span."""
    if state is not None:
        _local.on = True
        _local.stack = list(state)


@contextmanager
def _traced(name: str, phase: bool, ids: dict, sync=None):
    """Records the ``with`` body as a span (``sync``: a CUDA device whose
    current stream is synchronized at the end, counted as a wait)."""
    import torch
    stack = _local.stack
    if stack is None:
        stack = _local.stack = []
    s = Span(name, phase, stack[-1] if stack else None, ids)
    with torch.profiler.record_function(name):
        stack.append(s)
        s.start = time.perf_counter()
        try:
            yield
            if sync is not None:
                t = time.perf_counter()
                torch.cuda.current_stream(sync).synchronize()
                s.end = time.perf_counter()
                _add(s, {"wait_s": s.end - t, "waits": 1})
            else:
                s.end = time.perf_counter()
        finally:
            stack.pop()
    with _lock:
        if phase:
            SECONDS[name] = SECONDS.get(name, 0.0) + (s.end - s.start)
        SPANS.append(s)


@contextmanager
def timed(name: str, device=None):
    """A phase: adds the wall time of the ``with`` body to
    ``SECONDS[name]``; with a CUDA ``device`` (a ``torch.device``), after a
    synchronize of this thread's current stream on it (not of the whole
    device, which would wait for other threads' streams too).  torch is
    imported only then, or while tracing, so that a host command never
    loads it.  While tracing, also a span (see the module's docstring)."""
    sync = device if device is not None and device.type == "cuda" else None
    if tracing():
        with _traced(name, True, {}, sync):
            yield
        return
    t0 = time.perf_counter()
    yield
    if sync is not None:
        import torch
        torch.cuda.current_stream(sync).synchronize()
    dt = time.perf_counter() - t0
    with _lock:
        SECONDS[name] = SECONDS.get(name, 0.0) + dt


@contextmanager
def span(name: str, **ids):
    """A span for structure only, not summed into ``SECONDS``: recorded
    while tracing, with ``ids``, which every span inside it shares through
    its parents; nothing otherwise."""
    if not tracing():
        yield
        return
    with _traced(name, False, ids):
        yield
