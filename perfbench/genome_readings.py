"""What the readers of the genome cell's per-layer metrics (the ``.g24``
metrics, perfbench/metrics/) share: the drain of ``run_pipeline``'s worker
threads, read from the program's ``run_pipeline`` and ``group`` spans, and
the readers of the pipeline cell's metrics (``.rec``) whose formulas they
reuse, loaded from their files."""

from __future__ import annotations

import os

from program_spans import per_traced_job
from run import HERE, load_module


def reader(name: str):
    """The reader perfbench/metrics/<name>.py, loaded from its file."""
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "metric_" + name.replace(".", "_"))


def drain_s(spans) -> float | None:
    """Seconds, summed over the ``run_pipeline`` calls among ``spans``, from
    the end of the last group on the first worker thread to run out of
    groups to the end of the last group.  A call's groups are its
    ``group`` spans, each on its worker's thread; a worker that ran none
    (fewer threads than the call's ``workers`` counter) ran out at the
    first group's start.  None where a call has no ``workers`` counter,
    as a program that counts none."""
    total = 0.0
    for top in (s for s in spans if s.name == "run_pipeline"):
        if "workers" not in top.counts:
            return None
        groups = [s for s in spans if s.name == "group" and s.parent is top]
        if not groups:
            continue
        last: dict = {}
        for g in groups:
            last[g.thread] = max(last.get(g.thread, g.end), g.end)
        ends = list(last.values())
        if len(ends) < top.counts["workers"]:
            ends.append(min(g.start for g in groups))
        total += max(ends) - min(ends)
    return total


def per_traced_call(run, spans, fn) -> float | None:
    """``program_spans.per_traced_job`` of ``fn(its spans)``, a number or
    None: None when any traced job's reading is None."""
    missing = []

    def each(job, ss):
        v = fn(ss)
        if v is None:
            missing.append(job)
            return 0.0
        return v
    v = per_traced_job(run, spans, each)
    return None if missing else v
