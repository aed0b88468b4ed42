"""Seeded inputs of a whole-genome pair with named contigs, as
perfbench/configs/hc_grch38_24.json names them under ``inputs``.

``genome_inputs`` writes a genome pair whose contigs take the names and
the length shares of the configuration's ``contig_lengths`` (a published
assembly's chromosomes) over ``seq_len`` bases a side, and the gapless
records of every contig, contig after contig in the published order.  It
follows ``synth.build_genome``, with the shares read where that draws
them: contig i of the query is the target's contig i copied through its
alignment map, as a pair is (``synth.synth_workload``,
``copy_through_map``), the masking is ``synth``'s over each whole side,
and each contig gets ``round(n_records x share)`` records, at least one,
and ``int(m_columns x share)`` M columns.  Target contigs are named with
``target_prefix``, query contigs with ``query_prefix``.
"""

from __future__ import annotations

import os

import numpy as np

import synth


def contig_sizes(cfg) -> np.ndarray:
    """The bases of each contig: ``seq_len`` split in proportion to the
    published lengths, the remainder of the rounding down given one base
    at a time to the largest fractions, so that each lies within one base
    of its share and the contigs hold ``seq_len`` bases together."""
    pub = np.array(list(cfg["contig_lengths"].values()), dtype=np.int64)
    exact = cfg["seq_len"] * pub / pub.sum()
    lens = np.floor(exact).astype(np.int64)
    short = cfg["seq_len"] - int(lens.sum())
    lens[np.argsort(lens - exact, kind="stable")[:short]] += 1
    return lens


def contig_workload(rng, cfg, n, n_records, m_columns, names, tries=100):
    """``synth.synth_workload`` of one contig, drawn again from the same
    stream while its records do not fit the contig.  That happens only
    where a contig holds a few runs (the CPU tests' sizes), whose last run
    can overshoot the columns asked for by more than the slack; at the
    configuration's own sizes the first draw fits."""
    for _ in range(tries - 1):
        try:
            return synth.synth_workload(rng, cfg, n, n_records, m_columns,
                                        names)
        except ValueError:
            continue
    return synth.synth_workload(rng, cfg, n, n_records, m_columns, names)


def build(d, seed, cfg):
    """Write genome.fa (the target contigs, then the query contigs) and
    genome.paf (each contig's gapless records, contig after contig) into
    ``d``; returns (fasta, paf, [synth_workload dict per contig])."""
    rng = np.random.default_rng(seed + 23)
    lens = contig_sizes(cfg)
    total = int(lens.sum())
    works = [contig_workload(
        rng, cfg, n, max(1, round(cfg["n_records"] * n / total)),
        int(cfg["m_columns"] * n / total),
        (cfg["query_prefix"] + name, cfg["target_prefix"] + name))
        for name, n in zip(cfg["contig_lengths"], lens.tolist())]
    seqs = synth.ACGT[rng.integers(0, 4, 2 * total, dtype=np.uint8)]
    tseq, qseq = seqs[:total], seqs[total:]
    first = np.cumsum(lens) - lens
    shift = np.repeat(first, [len(w["runs"]) for w in works])

    def runs_of(key):
        return np.concatenate([w[key] for w in works])

    def fill():
        synth.copy_through_map(seqs, runs_of("runs"),
                               runs_of("qpos") + shift + total,
                               runs_of("tpos") + shift, runs_of("rev"),
                               cfg["keep_per_mille"], seed + 7)
        return qseq
    synth._mask_both(rng, cfg, tseq, fill, total / cfg["mask_scale_len"],
                     total)
    fa, paf = os.path.join(d, "genome.fa"), os.path.join(d, "genome.paf")
    with open(fa, "wb") as fh:
        for seq, side in ((tseq, 1), (qseq, 0)):
            for w, a, n in zip(works, first, lens):
                synth.write_fasta(fh, w["names"][side], seq[a: a + n],
                                  cfg["fasta_width"])
    with open(paf, "wb") as fh:
        for w in works:
            fh.write(synth.chain_input(w))
    for w, a, n in zip(works, first.tolist(), lens.tolist()):
        w["seqs"] = {w["names"][1]: tseq[a: a + n],
                     w["names"][0]: qseq[a: a + n]}
    return fa, paf, works


def genome_inputs(cfg, seed, workdir) -> dict:
    """The genome's files (genome.fa; genome.paf as the ``gapless`` input),
    its gapless records and its sequences by name, as
    ``synth.pair_inputs`` gives a pair's."""
    fa, paf, works = build(workdir, seed, cfg)
    seqs = {}
    for w in works:
        seqs.update(w["seqs"])
    return {"files": {"fasta": fa, "gapless": paf},
            "records": {"gapless": synth.concat_records(
                [synth.gapless_of(w) for w in works])},
            "seqs": seqs}
