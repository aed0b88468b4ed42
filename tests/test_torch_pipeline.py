"""The fused per-contig pipeline of paffy_tpu_torch against paffy_tpu's, on
the CPU: ``pipeline_stage``, and ``run_pipeline`` with 1 and 3 shards on a
workload of three query contigs, give paffy_tpu's bytes; ``add_mismatches
| chain | tile | trim`` run as four commands with files between them give
paffy_tpu's bytes at each step (on a workload and on chip_smoke's chain
input at a small scale); the sharding helpers are paffy_tpu's; and without
a device the pipeline raises before it encodes anything."""

import dataclasses

import numpy as np
import pytest
import torch

from paffy_tpu.cli import paffy_main as ref_main
from paffy_tpu.core import pafio as ref_pafio
from paffy_tpu.ops.mismatch import SequencePool as RefPool
from paffy_tpu.parallel import runner as ref_runner
from paffy_tpu_torch.cli import paffy_main as port_main
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops.mismatch import SequencePool
from paffy_tpu_torch.parallel import runner
from ref_native import paffy_tpu_lib  # noqa: F401
from synthdata import make_workload
from test_torch_host import SMALL, smoke_files

import chip_smoke


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("PAFFY_TPU_PLATFORM", "cpu")


def workload(seed):
    seqs, lines = make_workload(seed=seed, length=16000, n_windows=16,
                                window=1800, step=950)
    text = "\n".join(lines) + "\n"
    return seqs, pafio.parse_paf_text(text), ref_pafio.parse_paf_text(text)


def serialized(t, ref=False):
    return bytes((ref_pafio if ref else pafio).serialize_paf_bytes(t))


@pytest.mark.parametrize("seed", [8, 12])
def test_pipeline_stage_matches_paffy_tpu(seed):
    seqs, t, r = workload(seed)
    got = runner.pipeline_stage(t, SequencePool(seqs))
    want = ref_runner.pipeline_stage(r, RefPool(seqs))
    assert serialized(got) == serialized(want, ref=True)
    assert (got.chain_id >= 0).all() and (got.tile_level >= 1).all()


@pytest.mark.parametrize("n_shards", [1, 3])
def test_run_pipeline_matches_paffy_tpu(n_shards):
    seqs, t, r = workload(8)
    assert len(set(t.qname)) == 3
    got = runner.run_pipeline(t, seqs, n_shards=n_shards)
    want = ref_runner.run_pipeline(r, seqs, n_shards=n_shards)
    assert serialized(got) == serialized(want, ref=True)
    assert len(got) == len(t)


def test_run_pipeline_takes_a_pool():
    seqs, t, _ = workload(12)
    assert serialized(runner.run_pipeline(t, SequencePool(seqs))) == \
        serialized(runner.run_pipeline(t, seqs))


def test_sharding_helpers_match_paffy_tpu():
    seqs, t, r = workload(8)
    groups = runner.split_by_contig(t)
    want = ref_runner.split_by_contig(r)
    assert [g.tolist() for g in groups] == [g.tolist() for g in want]
    for by_query in (True, False):
        assert [g.tolist() for g in runner.split_by_contig(t, by_query)] == \
            [g.tolist() for g in ref_runner.split_by_contig(r, by_query)]
    lengths = [100, 90, 10, 5, 90]
    for n in (1, 2, 3):
        assert runner.assign_shards([None] * 5, lengths, n) == \
            ref_runner.assign_shards([None] * 5, lengths, n)
    half = len(t) // 2
    parts = [t.take(np.arange(half)), t.take(np.arange(half, len(t)))]
    assert serialized(runner.concat_tables(parts)) == serialized(t)
    raw = pafio.parse_paf_text("q\t9\t0\t9\t+\tt\t9\t0\t9\t9\t9\t60\n")
    raw = pafio.parse_paf_data(bytes(pafio.serialize_paf_bytes(raw)),
                               parse_cigars=False)
    with pytest.raises(AssertionError):
        runner.concat_tables([raw])


def test_concat_tables_of_no_tables_is_paffy_tpus_empty():
    got, want = runner.concat_tables([]), ref_runner.concat_tables([])
    assert len(got) == 0 and got.raw_cg is None and want.raw_cg is None
    for f in dataclasses.fields(want):
        if f.name == "raw_cg":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a.dtype, a.shape, a.tolist()) == (b.dtype, b.shape,
                                                  b.tolist()), f.name
    assert serialized(got) == serialized(want, ref=True) == b""


@pytest.mark.parametrize("raw_at", [0, 1], ids=["raw-first", "raw-second"])
def test_concat_tables_rejects_raw_cigars_as_paffy_tpu(raw_at):
    _, t, r = workload(8)
    data = serialized(t)
    tables = []
    for mod, table in ((pafio, t), (ref_pafio, r)):
        raw = mod.parse_paf_data(data, parse_cigars=False)
        tables.append([raw, table] if raw_at == 0 else [table, raw])
    errors = []
    for fn, ts in ((runner.concat_tables, tables[0]),
                   (ref_runner.concat_tables, tables[1])):
        with pytest.raises(AssertionError) as e:
            fn(ts)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == \
        "concat_tables requires parsed-cigar tables"


def run_chain_of_commands(d, fa, src):
    """add_mismatches, chain, tile and trim one after another, by
    paffy_tpu and by the port, each from paffy_tpu's previous output;
    the outputs of both at each step."""
    steps = []
    for cmd, extra in (("add_mismatches", [fa]), ("chain", []), ("tile", []),
                       ("trim", [])):
        outs = []
        for tag, main in (("ref", ref_main), ("port", port_main)):
            o = d / f"{tag}_{cmd}.paf"
            assert main([cmd, "-i", str(src), *map(str, extra),
                         "-o", str(o)]) == 0
            outs.append(o.read_bytes())
        steps.append((cmd, *outs))
        src = d / f"ref_{cmd}.paf"
    return steps


def test_commands_chained_by_files_match_paffy_tpu(tmp_path):
    seqs, lines = make_workload(seed=13, length=16000, n_windows=16,
                                window=1800, step=950)
    (tmp_path / "s.fa").write_text("".join(f">{k}\n{v}\n"
                                           for k, v in seqs.items()))
    (tmp_path / "in.paf").write_text("\n".join(lines) + "\n")
    for cmd, ref, port in run_chain_of_commands(
            tmp_path, tmp_path / "s.fa", tmp_path / "in.paf"):
        assert port == ref, cmd


def test_smoke_chain_input_pipeline_matches_paffy_tpu(tmp_path):
    # chip_smoke.py's chain and pipeline phases at a small scale: the
    # commands one after another, and run_pipeline, whose bytes are the
    # last command's
    fa, paf, w = smoke_files(tmp_path, False, **SMALL)
    src = tmp_path / "chain.paf"
    src.write_bytes(chip_smoke.chain_input(w, seq_len=SMALL["seq_len"]))
    steps = run_chain_of_commands(tmp_path, fa, src)
    for cmd, ref, port in steps:
        assert port == ref, cmd
    t = pafio.parse_paf_data(src.read_bytes())
    got = serialized(runner.run_pipeline(
        t, SequencePool.from_fasta_files([fa])))
    assert got == steps[-1][1]


def test_pipeline_without_device_raises_before_encoding(monkeypatch):
    seqs, t, _ = workload(8)
    monkeypatch.delenv("PAFFY_TPU_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        runner.run_pipeline(t, seqs)
