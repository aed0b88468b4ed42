"""At seed 0 the generator writes, byte for byte, the five input files that
chip_smoke.py pins (its PINS, made by paffy_tpu on a CPU), and the plain
reference gives the pinned outputs of add_mismatches and run_pipeline on
them.  At full size: about two minutes and 2 GB on one CPU core."""

import ast
import hashlib
import os

import numpy as np
import pytest

import reference
import synth
import tiny

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def pins() -> dict:
    """chip_smoke.PINS, read from its source (nothing of it is imported)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "PINS"):
            return ast.literal_eval(node.value)
    raise LookupError("no PINS in chip_smoke.py")


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def sha_file(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.file_digest(fh, "sha256").hexdigest()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair")
    fa, paf, w = synth.build_pair(str(d), 0, tiny.full("hc_chr10"))
    return fa, paf, w


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("genome")
    return synth.build_genome(str(d), 0, tiny.genome())


def test_pair_files_are_pinned(pair):
    fa, paf, w = pair
    p = pins()
    assert sha_file(fa) == p["seqs.fa"]
    assert sha_file(paf) == p["in.paf"]
    assert sha(synth.chain_input(w)) == p["chain.paf"]


def test_genome_files_are_pinned(genome):
    fa, paf, _, _ = genome
    p = pins()
    assert sha_file(fa) == p["genome.fa"]
    assert sha_file(paf) == p["genome.paf"]


def test_reference_add_mismatches_is_pinned(pair):
    _, _, w = pair
    out, work = reference.add_mismatches_jobs(synth.records_of(w),
                                              w["seqs"], ["whole"])
    assert sha(out["whole"]) == pins()["add_mismatches"]
    assert work["whole"][0]["columns"] == 125_000_569
    assert work["whole"][0]["m_runs"] == 216_159
    assert work["whole"][0]["eqx_runs"] == 6_586_416


def test_reference_run_pipeline_is_pinned(pair):
    _, _, w = pair
    out, work = reference.pipeline_jobs(synth.gapless_of(w), w["seqs"],
                                        ["whole"])
    assert sha(out["whole"]) == pins()["run_pipeline"]
    assert work["whole"][0]["candidates"] == 280_411_611


def test_reference_run_pipeline_genome_is_pinned(genome):
    _, _, _, works = genome
    seqs = {}
    for w in works:
        seqs.update(w["seqs"])
    recs = synth.concat_records([synth.gapless_of(w) for w in works])
    names = [w["names"][0] for w in works]
    out, work = reference.pipeline_jobs(recs, seqs, ["whole"] + names)
    assert sha(out["whole"]) == pins()["run_pipeline genome"]
    assert out["whole"] == b"".join(out[n] for n in names)
    assert sum(w["records"] for w in work["whole"]) == 216_913
    assert len(work["whole"]) == 24
    assert [len(w["runs"]) for w in works] == [
        x["records"] for x in work["whole"]]
    assert np.ptp([x["records"] for x in work["whole"]]) > 0
