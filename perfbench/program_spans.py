"""What the readers of the program's own spans share (the per-layer
metrics that read ``paffy_tpu_torch.phases.SPANS``): the spans that lie
inside each traced job of the window, on the clock the jobs are timed
with (``time.perf_counter``), and the sums the readers take of them.  The
program records spans only while the profiler runs, so only the traced
jobs have any.  A reader gives None when no traced job has a span, as on
a program that records none."""

from __future__ import annotations


def program_spans():
    """The program's span list, or None where the program keeps none."""
    from paffy_tpu_torch import phases
    return getattr(phases, "SPANS", None)


def per_traced_job(run, spans, fn) -> float | None:
    """The mean over the window's traced jobs of ``fn(job, its spans)``;
    ``spans`` None reads the program's.  None when no traced job has a
    span.  The spans are read, never cleared."""
    if spans is None:
        spans = program_spans()
    jobs = [j for j in run.jobs if j.traced]
    if not spans or not jobs:
        return None
    inside = [[s for s in spans if j.start <= s.start and s.end <= j.end]
              for j in jobs]
    if not any(inside):
        return None
    return sum(fn(j, ss) for j, ss in zip(jobs, inside)) / len(jobs)


def phase_s(*names):
    """fn for per_traced_job: seconds of the named phases, summed over
    threads."""
    def fn(job, spans):
        return sum(s.end - s.start for s in spans
                   if s.phase and s.name in names)
    return fn


def counted(*keys):
    """fn for per_traced_job: the sum of the named counters of every
    span."""
    def fn(job, spans):
        return sum(s.counts.get(k, 0) for s in spans for k in keys)
    return fn


def unspanned(job, spans) -> float:
    """fn for per_traced_job: the job's wall minus the union of its phase
    spans over every thread: its seconds in no phase."""
    covered, end = 0.0, job.start
    for a, b in sorted((s.start, s.end) for s in spans if s.phase):
        if b > end:
            covered += b - max(a, end)
            end = b
    return (job.end - job.start) - covered
