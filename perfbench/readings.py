"""What the metric readers (perfbench/metrics/<name>.py) share: seconds per
job from the program's phases and the benchmark's spans, the work each
job's key asks of the kernels (counted by the reference from the input),
the card's peaks (peaks.json) and the least time of a kernel's work."""

from __future__ import annotations

import json
import os

import devtrace

HERE = os.path.dirname(os.path.abspath(__file__))


def per_job(run, phases=(), spans=()) -> float | None:
    """Mean seconds per window job of the named program phases plus the
    named benchmark spans; None when no job ran any of them."""
    total, seen = 0.0, False
    for j in run.jobs:
        for n in phases:
            if n in j.phases:
                total += j.phases[n]
                seen = True
        for n in spans:
            if n in j.spans:
                total += j.spans[n]
                seen = True
    return total / len(run.jobs) if seen else None


def work_total(run, what: str) -> int:
    """The sum over the window's jobs of ``what`` (records, columns)."""
    return sum(w[what] for j in run.jobs for w in run.work[j.key])


def peaks(run) -> dict | None:
    """The card's published peaks, with its int32 rate worked out from its
    SMs and its highest SM clock as nvidia-smi gives it; None for a card
    the table lacks."""
    with open(os.path.join(HERE, "peaks.json")) as fh:
        table = json.load(fh)["cards"]
    name = run.card.get("name")
    if name not in table or "sm_clock_max_mhz" not in run.card:
        return None
    import torch
    sms = torch.cuda.get_device_properties(run.device).multi_processor_count
    pk = dict(table[name])
    pk["int32_ops_per_s"] = (sms * pk["int32_lanes_per_sm"]
                             * run.card["sm_clock_max_mhz"] * 1e6)
    return pk


def roofline(run, kernels, least_s) -> float | None:
    """100 x the least time of the traced jobs' work for ``kernels`` (the
    sum over their launches of ``least_s(work, peaks)``) over those
    kernels' device seconds in the trace; None without a trace, a peak or
    a launch."""
    pk = peaks(run)
    dev_s = devtrace.kernel_s(run.spans, *kernels)
    if pk is None or dev_s <= 0:
        return None
    least = sum(least_s(w, pk) for j in run.jobs if j.traced
                for w in run.work[j.key])
    return 100.0 * least / dev_s


def idle_share(run) -> float | None:
    """100 x the share of the traced window with no device operation."""
    if not run.spans or run.spans["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.spans["busy_s"] / run.spans["window_s"])
