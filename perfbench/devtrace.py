"""Reduction of a torch.profiler Chrome trace of the traced jobs to what the
per-layer metrics read: the traced window (the first job span's start to
the last one's end), the device's busy seconds in it (the union of its
kernels, copies and sets), each device operation's seconds by name, and
the longest idle gaps, each labelled by the innermost of the benchmark's
own spans (perfbench/jobs.py) the host was in at the gap's middle."""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _union(spans):
    """Merged, sorted intervals of ``spans`` (start, end)."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(path: str) -> dict:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and "dur" in e]
    jobs = [e for e in marks if e["name"] == "job"]
    if not jobs:
        return {"busy_s": 0.0, "window_s": 0.0, "ops_s": {},
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    w0 = min(float(e["ts"]) for e in jobs)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in jobs)
    ops_s: dict = {}
    spans = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        ops_s[e["name"]] = ops_s.get(e["name"], 0.0) + (b - a) / 1e6
        spans.append((a, b))
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) / 1e6
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    marks = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in marks), key=lambda m: m[1] - m[0])

    def label(t):
        for a, b, name in marks:          # the shortest span holding t
            if a <= t <= b:
                return name
        return "between jobs"
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "busy_s": busy_s, "window_s": (w1 - w0) / 1e6, "ops_s": ops_s,
        "breakdown": {
            "device_ops": sorted(([n[:160], s] for n, s in ops_s.items()),
                                 key=lambda x: -x[1])[:TOP],
            "idle_gaps": [[label((a + b) / 2), (b - a) / 1e6]
                          for a, b in longest]}}


def kernel_s(trace: dict | None, *names: str) -> float:
    """Seconds of the device operations whose names hold any of ``names``."""
    if not trace:
        return 0.0
    return sum(s for n, s in trace["ops_s"].items()
               if any(k in n for k in names))
