"""The readers of the program's own spans (perfbench/program_spans.py and
the metrics that use it): each gives the expected number from a
hand-built run and span list, and None where no traced job has a span; a
reader given no list reads the program's ``phases.SPANS``; and a traced
run of each cell on the program's CPU path reports every one of them that
the cell lists."""

import os
from types import SimpleNamespace

import pytest

import run
import tiny

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each reader with its reading of the hand-built run below
EXPECTED = {
    "unspanned_s.col": (0.9 + 0.5) / 2,
    "unspanned_s.rec": (0.9 + 0.5) / 2,
    "device_wait_s.col": (0.01 + 0.002 + 0.005 + 0.004) / 2,
    "device_wait_s.rec": (0.01 + 0.002 + 0.005 + 0.004) / 2,
    "device_waits.rec": (3 + 2) / 2,
    "copy_mb.col": (300 + 270 + 1 + 2) / 2,
    "copy_mb.rec": (300 + 270 + 1 + 2) / 2,
    "runner_s.rec": (0.1 + 0.1 + 0.15 + 0.1) / 2,
    "fasta_s.rec": (0.5 + 0.1 + 0.1 + 0.4 + 0.1) / 2,
}


def reader(name):
    return run.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                           "metric_" + name.replace(".", "_"))


def job(start, end, traced):
    return SimpleNamespace(start=start, end=end, traced=traced,
                           wall=end - start)


def span(name, start, end, phase=True, **counts):
    return SimpleNamespace(name=name, start=start, end=end, phase=phase,
                           counts=counts)


def hand_built():
    """Two traced jobs (walls 2 s and 1 s) and one untraced, and spans: in
    the first job phases on several threads, two of them overlapping, and
    a structural span with counters; in the second two phases; one span
    across the first job's end and one in the untraced job, both left
    out."""
    jobs = [job(10.0, 12.0, True), job(20.0, 21.0, True),
            job(30.0, 31.0, False)]
    spans = [
        span("fasta", 10.0, 10.5, bytes_up=300e6),
        span("pool upload", 10.5, 10.6, wait_s=0.01, waits=1,
             bytes_up=270e6),
        span("K2", 10.6, 10.7, wait_s=0.002, waits=1),
        span("split", 10.7, 10.8),
        span("gather", 10.8, 10.9),
        span("gather", 10.85, 11.0),
        span("concat", 11.5, 11.6, bytes_down=1e6),
        span("run_pipeline", 10.7, 11.7, phase=False, wait_s=0.005,
             waits=1),
        span("fasta", 11.9, 12.1, bytes_up=1e9, waits=9),
        span("fasta", 20.0, 20.4),
        span("K2", 20.4, 20.5, wait_s=0.004, waits=2, bytes_down=2e6),
        span("fasta", 30.0, 30.5, waits=7, wait_s=1.0),
    ]
    return run.RunData(jobs=jobs), spans


def test_every_new_reader_is_in_the_benchmark():
    names = {m["name"]: m for m in tiny.bench()["per_layer"]}
    for name in EXPECTED:
        assert names[name]["source"] == "program_span"
        assert len(names[name]["workloads"]) == 1


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_hand_built_spans(name):
    data, spans = hand_built()
    assert reader(name).read(data, spans) == pytest.approx(EXPECTED[name],
                                                           rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_none_without_traced_spans(name):
    data, spans = hand_built()
    r = reader(name)
    assert r.read(data, []) is None
    for j in data.jobs:
        j.traced = False
    assert r.read(data, spans) is None
    data.jobs[2].traced = True          # traced, but not the spans' jobs
    data.jobs[2].start = 40.0
    data.jobs[2].end = 41.0
    assert r.read(data, spans) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_programs_spans(name, monkeypatch):
    from paffy_tpu_torch import phases
    data, spans = hand_built()
    monkeypatch.setattr(phases, "SPANS", spans)
    assert reader(name).read(data) == pytest.approx(EXPECTED[name],
                                                    rel=1e-12)
    monkeypatch.delattr(phases, "SPANS")   # a program without spans
    assert reader(name).read(data) is None


@pytest.mark.parametrize("cell", ["hc_chr10.add_mismatches",
                                  "hc_chr10.pipeline"])
def test_traced_run_reports_the_span_metrics(cell, on_cpu):
    spec = {w["name"]: w for w in tiny.bench()["workloads"]}[cell]
    rc, res = run.run_cell(cell, 2**33 + 13, 0.5, True, require_cuda=False,
                           config=tiny.config(spec["config"]))
    assert rc == 0 and res["correct"]
    specs = {m["name"]: m for m in tiny.bench()["per_layer"]}
    mine = {n for n in EXPECTED if cell in specs[n]["workloads"]}
    assert mine and mine <= set(res["metrics"])
    for n in mine:
        v = res["metrics"][n]["value"]
        assert v >= 0
        if specs[n]["unit"] == "s":
            assert v <= res["window"]["window_s"]
