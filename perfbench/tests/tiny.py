"""Configurations for the CPU tests: those of perfbench/configs/ with the
scale cut so that a run takes seconds on the CPU, and chip_smoke.py's
genome, which no cell runs, for the generator's pins."""

import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def full(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as fh:
        return json.load(fh)


def config(name: str) -> dict:
    cfg = full(name)
    cfg.update(seq_len=400_000, n_records=7, m_columns=330_000)
    return cfg


def genome() -> dict:
    """chip_smoke.py's pinned genome: hc_chr10's sizes over 24 contig pairs,
    lengths log-uniform over a factor of 12."""
    return dict(full("hc_chr10"), contigs=24, spread=12)


def bench() -> dict:
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as fh:
        return json.load(fh)
