"""The port's phases as spans (paffy_tpu_torch.phases), on the CPU.  Under a
torch.profiler run, run_pipeline on a small multi-contig genome at 1 and 2
workers records every phase and span inside its parent, each worker's
spans under their own ``group`` span and every group under
``run_pipeline``, the seconds of each name's phase spans equal to
``SECONDS``, no span under one of its own name, and each span of the
caller's thread as a ``user_annotation`` of the profiler's Chrome trace;
the output bytes are those of an untraced run.  With the profiler off no
span is recorded and ``SECONDS`` holds the same phases.  add_mismatches
and view through paffy_main nest no phase in one of its own name; the
counters go to the innermost open span, and nowhere with tracing off;
PAFFY_TPU_PROFILE's profiler, of every thread, holds the workers' spans;
and a host command still loads no torch."""

import collections
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from paffy_tpu_torch import native, phases
from paffy_tpu_torch.cli import paffy_main
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops.mismatch import SequencePool
from paffy_tpu_torch.parallel import runner
from paffy_tpu_torch.utils import logging as plog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS_ENV = "PAFFY_TPU_PIPELINE_THREADS"
SIZES = dict(seq_len=400_000, n_records=12, m_columns=300_000)
N_CONTIGS = 4
# the spans of run_pipeline that lie outside every contig group
CALLER_ONLY = {"run_pipeline", "split", "concat"}


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """(fasta, gapless PAF bytes) of a seeded pair of N_CONTIGS contigs."""
    d = tmp_path_factory.mktemp("genome")
    fa, paf, _, _ = chip_smoke.build_genome(str(d), native,
                                            n_contigs=N_CONTIGS, **SIZES)
    with open(paf, "rb") as fh:
        return fa, fh.read()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(fasta, gapped PAF) of a seeded chromosome pair at a small size."""
    d = tmp_path_factory.mktemp("pair")
    fa, paf, _ = chip_smoke.build_files(str(d), native, **SIZES)
    return fa, paf


def traced(fn, trace_path=None):
    """fn() under a CPU torch.profiler run: (its result, the spans it
    added, SECONDS after it); the trace written to ``trace_path``."""
    phases.SPANS.clear()
    phases.reset()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    spans = list(phases.SPANS)
    phases.SPANS.clear()
    return out, spans, dict(phases.SECONDS)


def ancestors(s):
    p = s.parent
    while p is not None:
        yield p
        p = p.parent


def pipeline(fa, data):
    def run():
        t = pafio.parse_paf_data(data)
        return bytes(pafio.serialize_paf_bytes(runner.run_pipeline(
            t, SequencePool.from_fasta_files([fa]))))
    return run


def check_tree(spans, seconds):
    """Each span inside its parent, none under one of its own name, and the
    phase spans' seconds by name equal to ``seconds``."""
    assert spans
    for s in spans:
        assert s.start <= s.end
        if s.parent is not None:
            assert s.parent.start <= s.start and s.end <= s.parent.end, s
        assert s.name not in {a.name for a in ancestors(s)}, s
    sums = collections.defaultdict(float)
    for s in spans:
        if s.phase:
            sums[s.name] += s.end - s.start
    assert set(sums) == set(seconds)
    for name, v in seconds.items():
        assert sums[name] == pytest.approx(v, rel=1e-9, abs=1e-12), name


@pytest.mark.parametrize("n_workers", [1, 2])
def test_run_pipeline_spans(genome, monkeypatch, tmp_path, n_workers):
    fa, data = genome
    monkeypatch.setenv(THREADS_ENV, str(n_workers))
    want = pipeline(fa, data)()
    trace = tmp_path / "trace.json"
    got, spans, seconds = traced(pipeline(fa, data), trace)
    assert got == want
    check_tree(spans, seconds)
    assert {"fasta", "split", "gather", "concat"} <= set(seconds)
    tops = [s for s in spans if s.name == "run_pipeline"]
    assert len(tops) == 1 and not tops[0].phase and tops[0].parent is None
    top = tops[0]
    groups = [s for s in spans if s.name == "group"]
    assert sorted(g.ids["group"] for g in groups) == list(range(N_CONTIGS))
    assert sum(g.ids["records"] for g in groups) == data.count(b"\n")
    for g in groups:
        assert top in ancestors(g)
    caller = top.thread
    assert (len({g.thread for g in groups} - {caller})
            == (0 if n_workers == 1 else min(n_workers, N_CONTIGS)))
    for s in spans:
        if s.name in CALLER_ONLY:
            assert s.thread == caller
            assert all(a.name != "group" for a in ancestors(s))
        elif s.name not in ("group", "fasta"):
            # a stage's span: under its own thread's group span
            g = next(a for a in ancestors(s) if a.name == "group")
            assert g.thread == s.thread
    assert sum(s.name == "gather" for s in spans) == N_CONTIGS
    # the caller's spans are the trace's user annotations
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    marks = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation")
    mine = collections.Counter(s.name for s in spans if s.thread == caller)
    for name, n in mine.items():
        assert marks[name] >= n, name


def test_run_pipeline_untraced_records_no_span(genome, monkeypatch):
    fa, data = genome
    monkeypatch.setenv(THREADS_ENV, "2")
    _, _, seconds = traced(pipeline(fa, data))
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    phases.SPANS.clear()
    phases.reset()
    pipeline(fa, data)()
    assert phases.SPANS == [] and calls == []
    assert set(phases.SECONDS) == set(seconds)
    assert all(v > 0 for v in phases.SECONDS.values())
    phases.reset()


@pytest.mark.parametrize("argv", [
    ["add_mismatches", "-i", "{paf}", "{fa}", "-o", "{out}"],
    ["view", "-i", "{paf}", "-s", "{fa}", "-o", "{out}"]],
    ids=["add_mismatches", "view"])
def test_commands_nest_no_phase_in_its_own_name(pair, tmp_path, argv):
    fa, paf = pair
    args = [a.format(fa=fa, paf=paf, out=tmp_path / "out") for a in argv]
    rc, spans, seconds = traced(lambda: paffy_main(list(args)))
    assert rc == 0
    check_tree(spans, seconds)
    assert [s.name for s in spans].count("fasta") == 1
    assert {"fasta", "pool upload", "K2", "parse"} <= set(seconds)
    # the same command untraced writes the same bytes
    first = (tmp_path / "out").read_bytes()
    assert paffy_main(list(args)) == 0
    assert (tmp_path / "out").read_bytes() == first


def test_counters_go_to_the_innermost_open_span():
    def work():
        phases.count(waits=1)              # no span open: dropped
        with phases.span("group", group=3, records=2):
            with phases.timed("a"):
                phases.count(bytes_up=3)
                with phases.timed("b"):
                    phases.count(bytes_up=5, waits=1)
                    phases.count(waits=1)
                phases.count(bytes_down=7)
    _, spans, seconds = traced(work)
    check_tree(spans, seconds)
    by = {s.name: s for s in spans}
    assert by["b"].counts == {"bytes_up": 5, "waits": 2}
    assert by["a"].counts == {"bytes_up": 3, "bytes_down": 7}
    assert by["group"].counts == {} and by["group"].ids == {"group": 3,
                                                            "records": 2}
    assert by["b"].parent is by["a"] and by["a"].parent is by["group"]
    # tracing off: no span open, counters go nowhere
    assert not phases.tracing() and not phases.recording()
    work()
    assert phases.SPANS == []


def test_a_block_that_raises_leaves_no_span():
    def work():
        with phases.timed("a"):
            with pytest.raises(ValueError):
                with phases.timed("b"):
                    raise ValueError("x")
    _, spans, seconds = traced(work)
    assert [s.name for s in spans] == ["a"] and set(seconds) == {"a"}
    assert not phases.recording()


def test_profile_env_trace_holds_the_workers_spans(genome, monkeypatch,
                                                   tmp_path):
    """PAFFY_TPU_PROFILE's profiler (of every thread, where torch offers
    it) turns tracing on, and its trace holds each group's span, from
    whichever worker ran it."""
    fa, data = genome
    monkeypatch.setenv(THREADS_ENV, "2")
    phases.SPANS.clear()
    prof = plog._start_profiler()
    try:
        assert phases.tracing()
        pipeline(fa, data)()
    finally:
        prof.stop()
    assert not phases.tracing()
    spans = list(phases.SPANS)
    phases.SPANS.clear()
    assert sum(s.name == "group" for s in spans) == N_CONTIGS
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as fh:
        events = json.load(fh)["traceEvents"]
    groups = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == "group"]
    try:
        torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return            # a torch without the option: the caller's only
    assert len(groups) == N_CONTIGS
    assert len({e["tid"] for e in groups}) == 2


def test_host_command_loads_no_torch(pair, tmp_path):
    _, paf = pair
    code = ("import sys\n"
            "from paffy_tpu_torch.cli import paffy_main\n"
            "rc = paffy_main(['invert', '-i', sys.argv[1], '-o', "
            "sys.argv[2]])\n"
            "print(rc, sorted(m for m in sys.modules if m == 'torch' "
            "or m.startswith('torch.')))\n")
    p = subprocess.run([sys.executable, "-c", code, paf,
                        str(tmp_path / "inv.paf")], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split("\n")[0] == "0 []"
    assert (tmp_path / "inv.paf").stat().st_size > 0
