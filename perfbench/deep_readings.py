"""What the readers of the deep tile cell's per-layer metrics (the
``.deep`` metrics, perfbench/metrics/) share: the counters of K5's plan,
read from the program's ``K5 tiles`` spans (ops/tile_device.tile_sweep:
``batches``, ``hist_mb``, ``carried_mb``)."""

from __future__ import annotations

from genome_readings import per_traced_call


def plan_counter(run, key: str, spans=None) -> float | None:
    """The mean over the traced jobs of the counter ``key`` summed over each
    job's ``K5 tiles`` spans; None where a traced job has no such span
    holding it, as on a program that counts none."""
    def fn(ss):
        held = [s.counts[key] for s in ss
                if s.name == "K5 tiles" and key in s.counts]
        return sum(held) if held else None
    return per_traced_call(run, spans, fn)
