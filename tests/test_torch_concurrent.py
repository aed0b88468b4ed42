"""run_pipeline's contig groups in worker threads (PAFFY_TPU_PIPELINE_THREADS)
in paffy_tpu_torch against paffy_tpu, on the CPU, on chip_smoke.py's
many-contig genome (chip_smoke.build_genome) at small scales: the bytes at
1, 2, 4 and 8 workers with 1 and 3 shards equal paffy_tpu's and the
port's serial run, and stay the same over repeated runs; a failing group
raises paffy_tpu's error, that of the first failing group in run order;
one worker and a mesh take the serial loop; and the shared state the
workers reach (phases.SECONDS, kernels.LAUNCHES, SequencePool.ext) counts
and builds exactly once when threads use it at once; paf_chain on four
threads at once gives the bytes of one."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paffy_tpu.core import pafio as ref_pafio
from paffy_tpu.core.fasta import read_fasta
from paffy_tpu.parallel import runner as ref_runner
from paffy_tpu_torch import kernels, native, phases
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops import chain, mismatch
from paffy_tpu_torch.ops.mismatch_device import build_ext_pool_plain
from paffy_tpu_torch.ops.mismatch import SequencePool
from paffy_tpu_torch.parallel import runner
from paffy_tpu_torch.parallel.pipeline import make_mesh
from ref_native import paffy_tpu_lib  # noqa: F401
from test_torch_host import SMALL

import chip_smoke

THREADS_ENV = "PAFFY_TPU_PIPELINE_THREADS"
# the grid's genome: SMALL's sizes in 8 contigs
GRID = dict(SMALL, n_contigs=8)
# the chip's 24 contigs; SMALL's sizes are too short for them (a contig's
# last M run would pass its end), so three times SMALL, and four times its
# records, so that most contigs hold records on both strands
GENOME_SMALL = dict(n_contigs=chip_smoke.GENOME_CONTIGS,
                    seq_len=3 * SMALL["seq_len"],
                    n_records=4 * SMALL["n_records"],
                    m_columns=3 * SMALL["m_columns"])


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


def genome(d, **sizes):
    """(fasta, the PAF's bytes) of chip_smoke.build_genome through the
    port's native library."""
    os.makedirs(d, exist_ok=True)
    fa, paf, _, _ = chip_smoke.build_genome(str(d), native, **sizes)
    with open(paf, "rb") as fh:
        return fa, fh.read()


@pytest.fixture(scope="module")
def grid_genome(tmp_path_factory):
    return genome(tmp_path_factory.mktemp("grid"), **GRID)


def port_run(fa, data, n_shards=1, seqs=None):
    t = pafio.parse_paf_data(data)
    pool = (SequencePool(seqs) if seqs is not None
            else SequencePool.from_fasta_files([fa]))
    return bytes(pafio.serialize_paf_bytes(
        runner.run_pipeline(t, pool, n_shards=n_shards)))


def ref_run(fa, data, n_shards=1, seqs=None):
    t = ref_pafio.parse_paf_data(data)
    return bytes(ref_pafio.serialize_paf_bytes(ref_runner.run_pipeline(
        t, read_fasta(fa) if seqs is None else seqs, n_shards=n_shards)))


@pytest.fixture(scope="module")
def serial_bytes(grid_genome):
    """The port's serial output on the grid's genome, per shard count."""
    fa, data = grid_genome
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(THREADS_ENV, "1")
        mp.setenv("PAFFY_TPU_PLATFORM", "cpu")
        return {n: port_run(fa, data, n) for n in (1, 3)}


def test_grid_genome_has_uneven_contigs(grid_genome):
    fa, data = grid_genome
    t = pafio.parse_paf_data(data)
    groups = runner.split_by_contig(t)
    lens = sorted(int(t.qlen[g[0]]) for g in groups)
    assert len(groups) == GRID["n_contigs"] >= 6
    assert lens[-1] >= 10 * lens[0]
    assert set(t.strand.tolist()) == {True, False}
    assert set(read_fasta(fa)) == {f"{r}_chr{i + 1}" for r in "qt"
                                   for i in range(GRID["n_contigs"])}


@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("n_workers", [1, 2, 4, 8])
def test_threaded_run_pipeline_matches_paffy_tpu(
        monkeypatch, grid_genome, serial_bytes, n_workers, n_shards):
    fa, data = grid_genome
    monkeypatch.setenv(THREADS_ENV, str(n_workers))
    got = port_run(fa, data, n_shards)
    assert got == ref_run(fa, data, n_shards)
    assert got == serial_bytes[n_shards]


def test_repeated_threaded_runs_give_the_same_bytes(monkeypatch,
                                                    grid_genome,
                                                    serial_bytes):
    fa, data = grid_genome
    monkeypatch.setenv(THREADS_ENV, "8")
    outs = {port_run(fa, data) for _ in range(5)}
    assert outs == {serial_bytes[1]}


@pytest.mark.parametrize("n_workers", [1, 2, 4, 8])
def test_workers_are_threads_up_to_the_count(monkeypatch, grid_genome,
                                             n_workers):
    """The groups run in at most n_workers threads, other than the
    caller's unless n_workers is 1, and each group exactly once."""
    fa, data = grid_genome
    seen = []
    stage = runner.sharded_pipeline_stage

    def spy(t, pool, mesh):
        seen.append((threading.get_ident(), t.qname[0]))
        time.sleep(0.02)          # hold the thread so others start
        return stage(t, pool, mesh)
    monkeypatch.setattr(runner, "sharded_pipeline_stage", spy)
    monkeypatch.setenv(THREADS_ENV, str(n_workers))
    port_run(fa, data)
    threads = {tid for tid, _ in seen}
    assert sorted(name for _, name in seen) == sorted(
        f"q_chr{i + 1}" for i in range(GRID["n_contigs"]))
    if n_workers == 1:
        assert threads == {threading.get_ident()}
    else:
        assert 1 < len(threads) <= n_workers
        assert threading.get_ident() not in threads


@pytest.mark.parametrize("case", ["one worker", "mesh"])
def test_serial_loop_without_worker_threads(monkeypatch, grid_genome,
                                            serial_bytes, case):
    """One worker, or a mesh at any worker count, runs the groups one
    after another in the caller's thread, as paffy_tpu does."""
    fa, data = grid_genome

    def no_threads(*args):
        raise AssertionError("worker threads started")
    monkeypatch.setattr(runner, "map_on_streams", no_threads)
    monkeypatch.setenv(THREADS_ENV, "1" if case == "one worker" else "8")
    t = pafio.parse_paf_data(data)
    mesh = (make_mesh([torch.device("cpu")] * 2, dp=2) if case == "mesh"
            else None)
    got = runner.run_pipeline(t, SequencePool.from_fasta_files([fa]),
                              mesh=mesh)
    assert bytes(pafio.serialize_paf_bytes(got)) == serial_bytes[1]


@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("n_workers", [1, 8])
def test_failing_groups_raise_paffy_tpus_error(monkeypatch, grid_genome,
                                               n_workers, n_shards):
    """Two groups whose query sequences are missing: both packages raise
    the same error, that of the one first in run order."""
    fa, data = grid_genome
    seqs = read_fasta(fa)
    t = pafio.parse_paf_data(data)
    groups = runner.split_by_contig(t)
    shards = runner.assign_shards(
        groups, [int(t.qlen[g[0]]) for g in groups], n_shards)
    order = [gi for s in shards for gi in s]
    # the largest group and the smallest, in either order
    big, small = sorted(order, key=lambda gi: -len(groups[gi]))[::len(
        order) - 1]
    first = min((big, small), key=order.index)
    missing = [t.qname[groups[gi][0]] for gi in (big, small)]
    for name in missing:
        del seqs[name]
    monkeypatch.setenv(THREADS_ENV, str(n_workers))
    errors = []
    for run in (ref_run, port_run):
        with pytest.raises(Exception) as e:
            run(fa, data, n_shards, seqs=seqs)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
    assert t.qname[groups[first][0]] in errors[1][1]


@pytest.fixture
def racy_switching():
    """Switch threads as often as the interpreter allows, so that an
    unlocked read-modify-write loses updates."""
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(saved)


class ThreadClock:
    """perf_counter for phases: each thread's own clock, one second per
    call, so each timed block adds exactly one second."""

    def __init__(self):
        self._local = threading.local()

    def perf_counter(self):
        self._local.t = getattr(self._local, "t", 0.0) + 1.0
        return self._local.t


@pytest.mark.parametrize("counter", ["phases.timed", "kernels.LAUNCHES"])
def test_shared_counters_are_exact_under_threads(monkeypatch,
                                                 racy_switching, counter):
    n_threads, n_each = 8, 4000
    start = threading.Barrier(n_threads, timeout=60)
    if counter == "phases.timed":
        monkeypatch.setattr(phases, "time", ThreadClock())
        phases.reset()

        def work():
            start.wait()
            for _ in range(n_each):
                with phases.timed("K6", torch.device("cpu")):
                    pass
    else:
        kernels.reset_launch_counts()

        def work():
            start.wait()
            for _ in range(n_each):
                kernels.count_launch("chain_dp")
    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    if counter == "phases.timed":
        assert phases.SECONDS == {"K6": float(n_threads * n_each)}
        phases.reset()
    else:
        assert kernels.LAUNCHES["chain_dp"] == n_threads * n_each
        assert sum(kernels.LAUNCHES.values()) == n_threads * n_each
        kernels.reset_launch_counts()


def test_pool_ext_is_built_once_under_threads(monkeypatch):
    builds = []
    build = mismatch.build_ext_pool

    def slow_build(raw):
        builds.append(threading.get_ident())
        time.sleep(0.05)          # a window for a second build
        return build(raw)
    monkeypatch.setattr(mismatch, "build_ext_pool", slow_build)
    rng = np.random.default_rng(3)
    pool = SequencePool({"a": "".join(rng.choice(list("ACGTacgtN"), 5000)),
                         "b": "ACGT" * 300})
    n_threads = 8
    start = threading.Barrier(n_threads, timeout=60)
    got = [None] * n_threads

    def ask(i):
        start.wait()
        got[i] = pool.ext if i % 2 else pool.ext_on(torch.device("cpu"))
    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert len(builds) == 1
    assert all(x is got[0] for x in got)
    assert torch.equal(got[0], build_ext_pool_plain(
        torch.from_numpy(pool.host_pool)))


def test_genome_synthesis_equals_paffy_tpus(tmp_path):
    from paffy_tpu import native as ref_native
    outs = []
    for tag, lib in (("ref", ref_native), ("port", native)):
        os.makedirs(tmp_path / tag)
        fa, paf, lens, works = chip_smoke.build_genome(
            str(tmp_path / tag), lib, **GENOME_SMALL)
        with open(fa, "rb") as f1, open(paf, "rb") as f2:
            outs.append((f1.read(), f2.read()))
    assert outs[0] == outs[1]
    assert len(lens) == chip_smoke.GENOME_CONTIGS
    assert lens.max() >= 10 * lens.min()
    assert outs[1][1].count(b"\n") == sum(len(w["runs"]) for w in works)
    assert b"\t-\t" in outs[1][1] and b"\t+\t" in outs[1][1]
    seqs = read_fasta(str(tmp_path / "port" / "genome.fa"))
    assert [len(seqs[f"q_chr{i + 1}"]) for i in range(len(lens))] == \
        lens.tolist()
    body = "".join(seqs.values())
    assert "N" in body and any(c.islower() for c in body)


def test_genome_run_pipeline_matches_paffy_tpu(monkeypatch, tmp_path):
    """chip_smoke's genome at 24 contigs through run_pipeline at the
    chip's worker counts: paffy_tpu's bytes."""
    fa, data = genome(tmp_path, **GENOME_SMALL)
    outs = set()
    for n_workers in sorted(set(chip_smoke.GENOME_THREADS)):
        monkeypatch.setenv(THREADS_ENV, str(n_workers))
        outs.add(port_run(fa, data))
    assert outs == {ref_run(fa, data)}


def test_paf_chain_on_four_threads_gives_one_threads_bytes(grid_genome):
    """paf_chain on four threads at once, each on the whole table or on
    one contig group, three times over, gives the bytes of one thread: the
    native extraction, which runs without the GIL, keeps no state between
    calls."""
    _, data = grid_genome
    t = pafio.parse_paf_data(data)
    groups = sorted(runner.split_by_contig(t), key=len)[-3:]
    tables = [t] + [t.take(g) for g in groups]

    def chained(x):
        return bytes(pafio.serialize_paf_bytes(chain.paf_chain(x)))
    want = [chained(x) for x in tables]
    start = threading.Barrier(len(tables), timeout=60)
    got = [None] * len(tables)

    def work(k):
        start.wait()
        got[k] = [chained(tables[k]) for _ in range(3)]
    threads = [threading.Thread(target=work, args=(k,))
               for k in range(len(tables))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert got == [[w] * 3 for w in want]
    assert all(b"cn:i:" in w for w in want)
