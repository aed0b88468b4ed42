"""run_pipeline on a whole genome pair of 24 named contigs, on the CPU: the
benchmark's hc_grch38_24 configuration (GRCh38's 24 chromosome length
shares) at a small size, built by perfbench's generator.  At 4 workers, at
1 worker and in the plain reference (perfbench/reference.py, which runs
the contig groups one after another) the output bytes are equal, and
each contig's slice of the port's output equals the reference's bytes for
that contig alone.  Under a torch.profiler run, run_pipeline's span
counts its 24 groups and 4 workers, and every group span carries its
group, records and contig length.  The reader of drain_s.g24 gives the
expected seconds on hand-built spans.  perfbench's modules are imported
here only, as the plain reference and the metric's reader."""

import copy
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from paffy_tpu_torch import phases
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops.mismatch import SequencePool
from paffy_tpu_torch.parallel import runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "perfbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import genome_readings  # noqa: E402
import reference  # noqa: E402
import synth_genome  # noqa: E402

THREADS_ENV = "PAFFY_TPU_PIPELINE_THREADS"
SIZES = dict(seq_len=400_000, n_records=24, m_columns=330_000)


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


def config() -> dict:
    with open(os.path.join(BENCH, "configs", "hc_grch38_24.json")) as fh:
        cfg = json.load(fh)
    cfg.update(SIZES)
    return cfg


@pytest.fixture(scope="module", params=[0, 2**31 + 11])
def genome(request, tmp_path_factory):
    """The genome's inputs at a seed, and the reference's bytes of every
    job key: the whole output and each query contig's."""
    cfg = config()
    inputs = synth_genome.genome_inputs(
        cfg, request.param, str(tmp_path_factory.mktemp("genome")))
    names = [cfg["query_prefix"] + n for n in cfg["contig_lengths"]]
    want, _ = reference.pipeline_jobs(inputs["records"]["gapless"],
                                      inputs["seqs"], ["whole"] + names)
    return inputs, names, want


def port(inputs, monkeypatch, n_workers):
    monkeypatch.setenv(THREADS_ENV, str(n_workers))
    with open(inputs["files"]["gapless"], "rb") as fh:
        t = pafio.parse_paf_data(fh.read())
    return runner.run_pipeline(
        t, SequencePool.from_fasta_files([inputs["files"]["fasta"]]))


def test_workers_and_reference_give_equal_bytes(genome, monkeypatch):
    inputs, _, want = genome
    four = bytes(pafio.serialize_paf_bytes(port(inputs, monkeypatch, 4)))
    one = bytes(pafio.serialize_paf_bytes(port(inputs, monkeypatch, 1)))
    assert four == one == want["whole"]


def test_each_contig_equals_its_slice(genome, monkeypatch):
    inputs, names, want = genome
    out = port(inputs, monkeypatch, 4)
    assert list(dict.fromkeys(out.qname.tolist())) == names
    for name in names:
        part = out.take(np.flatnonzero(out.qname == name))
        assert bytes(pafio.serialize_paf_bytes(part)) == want[name], name


def test_traced_call_counts_groups_workers_and_lengths(genome, monkeypatch):
    inputs, names, want = genome
    phases.SPANS.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = port(inputs, monkeypatch, 4)
    finally:
        prof.stop()
    spans = list(phases.SPANS)
    phases.SPANS.clear()
    assert bytes(pafio.serialize_paf_bytes(out)) == want["whole"]
    tops = [s for s in spans if s.name == "run_pipeline"]
    assert len(tops) == 1
    assert tops[0].counts["groups"] == 24
    assert tops[0].counts["workers"] == 4
    groups = sorted((s for s in spans if s.name == "group"),
                    key=lambda s: s.ids["group"])
    assert [g.ids["group"] for g in groups] == list(range(24))
    recs = inputs["records"]["gapless"]
    for g, name in zip(groups, names):
        assert set(g.ids) == {"group", "records", "length"}
        mine = recs["qname"] == name
        assert g.ids["records"] == int(mine.sum())
        assert g.ids["length"] == int(recs["qlen"][mine][0])
        assert g.parent is tops[0]
    assert 1 < len({g.thread for g in groups}) <= 4
    assert genome_readings.drain_s(spans) >= 0


def test_inline_call_counts_one_worker(genome, monkeypatch):
    inputs, _, _ = genome
    phases.SPANS.clear()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        port(inputs, monkeypatch, 1)
    finally:
        prof.stop()
    spans = list(phases.SPANS)
    phases.SPANS.clear()
    top = next(s for s in spans if s.name == "run_pipeline")
    assert top.counts["groups"] == 24 and top.counts["workers"] == 1
    assert genome_readings.drain_s(spans) == 0.0


# ------------------------------------------------- drain_s.g24, by hand

def _span(name, start, end, thread=0, parent=None, **counts):
    return SimpleNamespace(name=name, start=start, end=end, thread=thread,
                           parent=parent, phase=False, counts=counts)


def hand_built():
    """Two traced jobs.  In the first, run_pipeline counts 3 workers: thread
    1 runs groups until 18.0, thread 2 runs out of groups at 13.0, and the
    third ran no group, so it ran out at the first group's start, 10.5.
    In the second, the groups run inline on one thread."""
    top = _span("run_pipeline", 10.0, 19.0, workers=3, groups=4)
    second = _span("run_pipeline", 20.0, 24.0, workers=1, groups=2)
    spans = [
        top,
        _span("group", 10.5, 12.0, 1, top),
        _span("group", 12.0, 18.0, 1, top),
        _span("K6", 12.5, 13.5, 1),             # not a group: left out
        _span("group", 10.5, 11.0, 2, top),
        _span("group", 11.0, 13.0, 2, top),
        second,
        _span("group", 20.5, 22.0, 0, second),
        _span("group", 22.0, 23.5, 0, second),
    ]
    jobs = [SimpleNamespace(start=9.0, end=20.0, traced=True),
            SimpleNamespace(start=20.0, end=25.0, traced=True)]
    return SimpleNamespace(jobs=jobs), spans


def drain_reader():
    return genome_readings.reader("drain_s.g24")


def test_drain_reader_reads_the_hand_built_spans():
    run, spans = hand_built()
    assert genome_readings.drain_s(spans[:6]) == pytest.approx(18.0 - 10.5)
    assert drain_reader().read(run, spans) == pytest.approx(
        (18.0 - 10.5 + 0.0) / 2)
    # with two workers counted, the first to run dry is thread 2, at 13.0
    two = copy.copy(spans[0])
    two.counts = dict(spans[0].counts, workers=2)
    for s in spans[1:6]:
        if s.parent is spans[0]:
            s.parent = two
    assert genome_readings.drain_s([two] + spans[1:6]) == pytest.approx(
        18.0 - 13.0)


def test_drain_reader_gives_none_without_the_workers_counter():
    run, spans = hand_built()
    del spans[0].counts["workers"]      # a program that counts none
    assert drain_reader().read(run, spans) is None
    assert drain_reader().read(run, []) is None
