"""The whole-genome configuration hc_grch38_24 and its generator
(perfbench/synth_genome.py): the configuration holds GRCh38's 24
published chromosome lengths and its cut by 16; at seed 0 and a tiny size
the generator makes 24 contigs a side, each within one base of its
published share, and every record lies on its own contig pair; the
genome cell is in the benchmark with its seven metrics; the new yardstick
modules import nothing of the program."""

import os

import numpy as np
import pytest

import synth_genome
import tiny
from test_bench_imports import FORBIDDEN, top_level_imports

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "hc_grch38_24.pipeline"
# GRCh38.p14's primary chromosomes, as the assembly report gives them
GRCH38 = {
    "chr1": 248_956_422, "chr2": 242_193_529, "chr3": 198_295_559,
    "chr4": 190_214_555, "chr5": 181_538_259, "chr6": 170_805_979,
    "chr7": 159_345_973, "chr8": 145_138_636, "chr9": 138_394_717,
    "chr10": 133_797_422, "chr11": 135_086_622, "chr12": 133_275_309,
    "chr13": 114_364_328, "chr14": 107_043_718, "chr15": 101_991_189,
    "chr16": 90_338_345, "chr17": 83_257_441, "chr18": 80_373_285,
    "chr19": 58_617_616, "chr20": 64_444_167, "chr21": 46_709_983,
    "chr22": 50_818_468, "chrX": 156_040_895, "chrY": 57_227_415}


def test_configuration_pins_the_published_lengths():
    cfg = tiny.full("hc_grch38_24")
    assert cfg["contig_lengths"] == GRCH38
    assert list(cfg["contig_lengths"]) == list(GRCH38)
    assert sum(cfg["contig_lengths"].values()) == 3_088_269_832
    assert cfg["seq_len"] == 193_016_864 == 3_088_269_832 // 16
    assert set(cfg["reduced"]) == {"seq_len", "n_records", "m_columns"}
    hc = tiny.full("hc_chr10")
    for k in ("median_run", "indel_len", "rev_share", "keep_per_mille",
              "t_mask_stretches", "t_runs_of_n", "q_mask_stretches",
              "q_runs_of_n", "max_n_run", "mask_scale_len", "fasta_width"):
        assert cfg[k] == hc[k], k
    spec = {c["name"]: c for c in tiny.bench()["configs"]}["hc_grch38_24"]
    assert spec["reduced"] == cfg["reduced"]
    assert spec["file"] == "perfbench/configs/hc_grch38_24.json"


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    cfg = tiny.config("hc_grch38_24")
    d = tmp_path_factory.mktemp("genome")
    return cfg, synth_genome.genome_inputs(cfg, 0, str(d))


def test_contig_sizes_keep_the_published_shares():
    cfg = tiny.full("hc_grch38_24")
    lens = synth_genome.contig_sizes(cfg)
    pub = np.array(list(GRCH38.values()))
    assert lens.sum() == cfg["seq_len"]
    assert np.abs(lens - cfg["seq_len"] * pub / pub.sum()).max() <= 1


def test_genome_has_24_contigs_a_side_at_their_shares(genome):
    cfg, inputs = genome
    seqs = inputs["seqs"]
    pub = np.array(list(GRCH38.values()))
    share = cfg["seq_len"] * pub / pub.sum()
    for prefix in ("hs.", "pt."):
        got = np.array([len(seqs[prefix + n]) for n in GRCH38])
        assert np.abs(got - share).max() <= 1
    assert len(seqs) == 48
    with open(inputs["files"]["fasta"], "rb") as fh:
        heads = [ln[1:].decode() for ln in fh.read().split(b"\n")
                 if ln.startswith(b">")]
    assert heads == ([f"hs.{n}" for n in GRCH38]
                     + [f"pt.{n}" for n in GRCH38])


def test_every_record_lies_on_its_own_contig_pair(genome):
    cfg, inputs = genome
    recs = inputs["records"]["gapless"]
    q = np.array([n.removeprefix("pt.") for n in recs["qname"]])
    t = np.array([n.removeprefix("hs.") for n in recs["tname"]])
    assert (q == t).all()
    assert list(dict.fromkeys(q.tolist())) == list(GRCH38)
    qlen = np.array([len(inputs["seqs"][n]) for n in recs["qname"]])
    assert (recs["qlen"] == qlen).all() and (recs["tlen"] == qlen).all()
    assert (recs["qstart"] >= 0).all() and (recs["qend"] <= qlen).all()
    assert (recs["tstart"] >= 0).all() and (recs["tend"] <= qlen).all()
    with open(inputs["files"]["gapless"], "rb") as fh:
        assert fh.read().count(b"\n") == len(q)


def test_the_genome_cell_is_in_the_benchmark():
    bench = tiny.bench()
    spec = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (spec["config"], spec["traffic"], spec["chips"]) == (
        "hc_grch38_24", "pipeline", 1)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert CELL in e2e["records_per_s"]["workloads"]
    mine = {m["name"] for m in bench["per_layer"]
            if CELL in m.get("workloads", [CELL])}
    assert mine == {"drain_s.g24", "worker_overlap.g24", "runner_s.g24",
                    "k5_plan_s.g24", "k6_roofline.g24", "k5_roofline.g24",
                    "device_idle.g24"}


@pytest.mark.parametrize("name", ["synth_genome.py", "reference_view.py",
                                  "genome_readings.py"])
def test_new_yardstick_imports_nothing_of_the_program(name):
    mods = set(top_level_imports(os.path.join(BENCH, name)))
    assert not mods & (FORBIDDEN | {"paffy_tpu_torch", "chip_smoke",
                                    "torch"})
