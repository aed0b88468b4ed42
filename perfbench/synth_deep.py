"""Seeded input of the five-genome tile deployment, as
perfbench/configs/sub5_grch38_24.json names it under ``inputs``: one
genome's whole PAF in a Progressive Cactus subproblem, its alignments to
``target_genomes`` other genomes and to repeats stacked ``stack_depth``
deep, as ``paffy tile`` reads it.

``deep_inputs`` writes deep.paf and returns its records.  The query
contigs, their lengths and genome 0's records are
perfbench/synth_genome.py's at the same seed: the gapless records
``build`` draws (one per M run, ``synth.chain_input``'s fields), drawn
from the same stream and in the same order, with no sequence and no
FASTA (the tile reads none).  Then, from a stream of their own:

* genomes 1 .. target_genomes - 1 (target contigs ``g<g>.`` + genome 0's
  names): each of genome 0's records moved along its query contig by an
  offset uniform in [-genome_shift, genome_shift], clamped to the contig,
  its AS drawn anew, uniform up to genome 0's largest;
* the stacks: ``stack_loci`` x seq_len / stack_scale_len loci (at least
  one), each on a query contig drawn by length, under ``stack_depth``
  records, each spanning stack_len +- stack_len // 6 query bases from
  within ``stack_jitter`` of its locus, aligned to a seeded place on a
  seeded target contig of a seeded genome, on a seeded strand, gapless
  or with one 1-8 bp insertion or deletion, its AS uniform up to genome
  0's largest.

Every record has MAPQ 60, ``s1:i:0`` and a ``cg:Z:`` cigar; the file
holds genome 0, genomes 1, 2, ..., then the stacks.  The rule is
chip_smoke.py's ``deep_tile_input`` (DEEP_GENOMES, DEEP_SHIFT,
DEEP_LOCI, DEEP_STACK, DEEP_LEN, DEEP_JITTER).  The text is made with
NumPy, a column at a time, never a line at a time.
"""

from __future__ import annotations

import os

import numpy as np

import synth
import synth_genome

OP_M, OP_I, OP_D = synth.OP_M, synth.OP_I, synth.OP_D


def genome0(cfg, seed):
    """(contig lengths, [synth_workload dict per contig]) as
    ``synth_genome.build`` draws them at ``seed``, without its
    sequences."""
    rng = np.random.default_rng(seed + 23)
    lens = synth_genome.contig_sizes(cfg)
    total = int(lens.sum())
    works = [synth_genome.contig_workload(
        rng, cfg, n, max(1, round(cfg["n_records"] * n / total)),
        int(cfg["m_columns"] * n / total),
        (cfg["query_prefix"] + name, cfg["target_prefix"] + name))
        for name, n in zip(cfg["contig_lengths"], lens.tolist())]
    return lens, works


def n_loci(cfg) -> int:
    """The stacks' loci: ``stack_loci`` on ``stack_scale_len`` query bases,
    scaled to ``seq_len``, at least one."""
    return max(1, round(cfg["stack_loci"] * cfg["seq_len"]
                        / cfg["stack_scale_len"]))


def deep_columns(cfg, seed, lens, works) -> dict:
    """The records as columns, in file order: query contig ``qc``, query
    start ``q``, '+' ``fwd``, genome ``g``, target contig ``tc``, target
    start ``t``, AS ``score``, and the cigar: ``kind`` (0 gapless, 1 an
    insertion, 2 a deletion), ``m1`` (the first M run, or the only one),
    ``gap`` and ``m2`` (the indel and the M run after it; 0 when
    gapless)."""
    rng = np.random.default_rng(seed + 29)
    lens = np.asarray(lens, dtype=np.int64)
    cols = [synth.gapless_records(w) for w in works]
    contig = np.repeat(np.arange(len(works)), [len(c[0]) for c in cols])
    qs, fwd, ts, n, score = (np.concatenate([c[k] for c in cols])
                             for k in range(5))
    top = int(score.max())
    parts = []
    for g in range(cfg["target_genomes"]):
        q, a = qs, score
        if g:
            shift = cfg["genome_shift"]
            q = np.clip(qs + rng.integers(-shift, shift + 1, len(qs)), 0,
                        lens[contig] - n)
            a = rng.integers(0, top + 1, len(qs))
        zero = np.zeros(len(qs), dtype=np.int64)
        parts.append(dict(qc=contig, q=q, fwd=fwd, g=np.full(len(qs), g),
                          tc=contig, t=ts, score=a, kind=zero, m1=n,
                          gap=zero, m2=zero))
    # the stacks
    loci, depth = n_loci(cfg), cfg["stack_depth"]
    ln, jit = cfg["stack_len"], cfg["stack_jitter"]
    k, wide = loci * depth, ln // 6
    at = rng.choice(len(lens), loci, p=lens / lens.sum())
    locus = rng.integers(jit, lens[at] - ln - wide - jit)
    q_len = rng.integers(ln - wide, ln + wide + 1, k)
    q = np.repeat(locus, depth) + rng.integers(-jit, jit + 1, k)
    kind = rng.integers(0, 3, k)
    lo, hi = cfg["indel_len"]
    gap = rng.integers(lo, hi + 1, k)
    m1 = rng.integers(q_len // 4, 3 * q_len // 4)
    m2 = np.where(kind == 1, q_len - gap - m1, q_len - m1)
    t_len = np.where(kind == 2, q_len + gap, m1 + m2)
    g = rng.integers(0, cfg["target_genomes"], k)
    tc = rng.integers(0, len(lens), k)
    t = rng.integers(0, lens[tc] - t_len)
    s = rng.integers(0, 2, k) == 0
    a = rng.integers(0, top + 1, k)
    gapless = kind == 0
    parts.append(dict(qc=np.repeat(at, depth), q=q, fwd=s, g=g, tc=tc, t=t,
                      score=a, kind=kind, m1=np.where(gapless, q_len, m1),
                      gap=np.where(gapless, 0, gap),
                      m2=np.where(gapless, 0, m2)))
    return {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}


def names(works, n_genomes):
    """(query contig names, target contig names of every genome, genome
    after genome): index ``qc`` and ``g * len(works) + tc``."""
    return ([w["names"][0] for w in works],
            [f"g{g}." * (g > 0) + w["names"][1]
             for g in range(n_genomes) for w in works])


def spans(c):
    """(query span, target span, M columns, alignment block) of each
    record of ``deep_columns``."""
    m = c["m1"] + c["m2"]
    return (m + np.where(c["kind"] == 1, c["gap"], 0),
            m + np.where(c["kind"] == 2, c["gap"], 0), m, m + c["gap"])


def records(c, lens, works, n_genomes) -> dict:
    """The records of ``deep_columns`` as ``synth.records_of`` gives
    records (qname, ..., s1 0, the cigar as ops, lens, off)."""
    qspan, tspan, nm, block = spans(c)
    qn, tn = (synth._names(x) for x in names(works, n_genomes))
    indel = c["kind"] > 0
    n_ops = np.where(indel, 3, 1)
    off = np.zeros(len(n_ops) + 1, dtype=np.int64)
    np.cumsum(n_ops, out=off[1:])
    ops = np.full(off[-1], OP_M, dtype=np.uint8)
    lens_ = np.empty(off[-1], dtype=np.int64)
    first = off[:-1]
    lens_[first] = c["m1"]
    mid = first[indel] + 1
    ops[mid] = np.where(c["kind"][indel] == 1, OP_I, OP_D)
    lens_[mid] = c["gap"][indel]
    lens_[mid + 1] = c["m2"][indel]
    lens = np.asarray(lens, dtype=np.int64)
    k = len(c["q"])
    return dict(
        qname=qn[c["qc"]], qlen=lens[c["qc"]], qstart=c["q"],
        qend=c["q"] + qspan, fwd=c["fwd"].astype(bool),
        tname=tn[c["g"] * len(works) + c["tc"]], tlen=lens[c["tc"]],
        tstart=c["t"], tend=c["t"] + tspan, nmatch=nm, nbases=block,
        mapq=np.full(k, 60), score=c["score"],
        s1=np.zeros(k, dtype=np.int64), ops=ops, lens=lens_, off=off)


# ------------------------------------------------------------------ text

def _csr(counts):
    off = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    return off


def _number(v, keep=None):
    """(bytes, offsets) of the decimal text of non-negative ``v``, an empty
    text where ``keep`` is False."""
    v = np.asarray(v, dtype=np.int64)
    nd = np.ones(len(v), dtype=np.int64)
    p, top = 10, int(v.max(initial=0))
    while p <= top:
        nd += v >= p
        p *= 10
    if keep is not None:
        nd = np.where(keep, nd, 0)
    off = _csr(nd)
    buf = np.empty(off[-1], dtype=np.uint8)
    x = v.copy()
    for d in range(int(nd.max(initial=0))):
        live = nd > d
        buf[off[1:][live] - 1 - d] = (x[live] % 10 + 48).astype(np.uint8)
        x //= 10
    return buf, off


def _word(vocab, ids):
    """(bytes, offsets) of the text ``vocab[ids]`` (a list of bytes)."""
    size = np.array([len(w) for w in vocab], dtype=np.int64)
    at = _csr(size)
    allw = np.frombuffer(b"".join(vocab), dtype=np.uint8)
    ln = size[ids]
    off = _csr(ln)
    pos = np.repeat(at[:-1][ids] - off[:-1], ln) + np.arange(off[-1])
    return allw[pos], off


def _lines(pieces, k) -> bytes:
    """The ``k`` lines of ``pieces`` (each (bytes, offsets) of one text a
    line, or bytes, the same in every line), laid one after another."""
    pieces = [p if isinstance(p, tuple) else
              (np.frombuffer(p * k, dtype=np.uint8),
               np.arange(k + 1, dtype=np.int64) * len(p)) for p in pieces]
    row = _csr(sum(np.diff(off) for _, off in pieces))
    out = np.empty(row[-1], dtype=np.uint8)
    at = row[:-1].copy()
    for buf, off in pieces:
        ln = np.diff(off)
        out[np.repeat(at - off[:-1], ln) + np.arange(off[-1])] = buf
        at += ln
    return out.tobytes()


def paf_text(c, lens, works, n_genomes) -> bytes:
    """deep.paf: one line a record of ``deep_columns``, as
    chip_smoke.deep_tile_input writes it."""
    k = len(c["q"])
    lens = np.asarray(lens, dtype=np.int64)
    qspan, tspan, nm, block = spans(c)
    qn, tn = ([x.encode() for x in n] for n in names(works, n_genomes))
    indel = c["kind"] > 0
    return _lines([
        _word(qn, c["qc"]), b"\t", _number(lens[c["qc"]]), b"\t",
        _number(c["q"]), b"\t", _number(c["q"] + qspan), b"\t",
        _word([b"-", b"+"], c["fwd"].astype(np.int64)), b"\t",
        _word(tn, c["g"] * len(works) + c["tc"]), b"\t",
        _number(lens[c["tc"]]), b"\t", _number(c["t"]), b"\t",
        _number(c["t"] + tspan), b"\t", _number(nm), b"\t", _number(block),
        b"\t60\tAS:i:", _number(c["score"]), b"\ts1:i:0\tcg:Z:",
        _number(c["m1"]), b"M", _number(c["gap"], indel),
        _word([b"", b"I", b"D"], c["kind"]), _number(c["m2"], indel),
        _word([b"", b"M"], indel.astype(np.int64)), b"\n"], k)


def deep_inputs(cfg, seed, workdir) -> dict:
    """The deployment's file (deep.paf, the ``deep`` input), its records
    for the plain reference, and no sequences."""
    lens, works = genome0(cfg, seed)
    c = deep_columns(cfg, seed, lens, works)
    g = cfg["target_genomes"]
    paf = os.path.join(workdir, "deep.paf")
    with open(paf, "wb") as fh:
        fh.write(paf_text(c, lens, works, g))
    return {"files": {"deep": paf},
            "records": {"deep": records(c, lens, works, g)},
            "seqs": {}}
