"""Seeded inputs of the benchmark's cells, made on the host with NumPy.

A configuration file names its builder of inputs under ``inputs``, as
``module:function`` of perfbench (``function(config, seed, workdir)``
giving the cell's files, records and sequences).

* ``pair_inputs`` -- one chromosome pair (``build_pair``): a target and a
  query sequence of ``seq_len`` bases each, soft-masked with runs of N, and
  ``n_records`` gapped PAF records (in.paf) with ``m_columns`` M columns
  in runs of median ``median_run``, split by 1-8 bp indels, a
  ``rev_share`` of them on '-'.  The query is the target copied through
  the alignment map, ``keep_per_mille`` of its columns kept.  Its chain
  input (chain.paf) is one gapless record per M run.
* ``build_genome`` -- chip_smoke.py's genome, which no cell runs: a genome
  pair of ``contigs`` contig pairs holding ``seq_len`` bases a genome,
  lengths log-uniform over a factor of ``spread``; contig i of the query aligns to contig i of the target as a
  pair does, and the PAF (genome.paf) holds the gapless records of every
  contig, contig after contig.

At seed 0, with the sizes of perfbench/configs/hc_chr10.json (and for
the genome 24 contigs over a spread of 12), the files are byte for byte
those that chip_smoke.py pins (its ``PINS``);
perfbench/tests/test_bench_pins.py holds them to that.  Besides the
files, each builder returns the records as arrays (``records_of``,
``gapless_of``), so that the plain reference reads the alignment without
parsing text.
"""

from __future__ import annotations

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# complement of every IUPAC letter, both cases; every other byte is its own
COMP = np.arange(256, dtype=np.uint8)
COMP[np.frombuffer(b"acgtmrwsykvhdbnxACGTMRWSYKVHDBNX", dtype=np.uint8)] = (
    np.frombuffer(b"tgcakywsrmbdhvnxTGCAKYWSRMBDHVNX", dtype=np.uint8))
# cigar op codes: M, I (query only), D (target only), =, X
OP_M, OP_I, OP_D, OP_EQ, OP_X = range(5)

_MASK64 = (1 << 64) - 1
# columns copied through the alignment map per NumPy pass (bounds memory)
_COPY_CHUNK = 1 << 23


def synth_workload(rng, cfg, seq_len, n_records, m_columns, names):
    """The alignment of one contig pair: per M run its length, record, query
    position (of its first column, walking down the query on '-') and
    target position, per record its fields and cigar, and the PAF lines."""
    median = cfg["median_run"]
    runs = np.maximum(rng.lognormal(np.log(median), 0.8,
                                    int(m_columns / median * 1.2)), 1)
    runs = runs.astype(np.int64)
    n_runs = int(np.searchsorted(np.cumsum(runs), m_columns)) + 1
    runs = runs[:n_runs]
    cuts = np.sort(rng.choice(np.arange(1, n_runs), n_records - 1,
                              replace=False))
    first = np.zeros(n_runs, dtype=bool)
    first[0] = True
    first[cuts] = True
    run_rec = np.cumsum(first) - 1
    lo, hi = cfg["indel_len"]
    gap = rng.integers(lo, hi + 1, n_runs)
    gap[first] = 0
    is_ins = rng.random(n_runs) < 0.5
    ins = np.where(is_ins, gap, 0)
    dele = np.where(is_ins, 0, gap)
    rec_first = np.flatnonzero(first)

    def within_record_start(adv):
        # offset of each run's first column from its record's start
        end = np.cumsum(adv)
        base = (end - adv)[rec_first]
        return end - runs - base[run_rec]
    q_rel = within_record_start(ins + runs)
    t_rel = within_record_start(dele + runs)
    qspan = np.bincount(run_rec, weights=ins + runs).astype(np.int64)
    tspan = np.bincount(run_rec, weights=dele + runs).astype(np.int64)

    def place(span):
        slack = seq_len - int(span.sum())
        if slack <= n_records:
            raise ValueError("the records do not fit the sequences")
        gaps = rng.integers(0, slack // n_records, n_records)
        return np.cumsum(gaps + span) - span
    qs, ts = place(qspan), place(tspan)
    rev_rec = np.zeros(n_records, dtype=bool)
    rev_rec[rng.permutation(n_records)[
        : int(np.ceil(cfg["rev_share"] * n_records))]] = True
    rev = rev_rec[run_rec]
    qpos = np.where(rev, (qs + qspan - 1)[run_rec] - q_rel,
                    qs[run_rec] + q_rel)
    tpos = ts[run_rec] + t_rel

    # the cigar: each run's indel (none before a record's first) then its M
    tok_len = np.stack([gap, runs], axis=1).ravel()
    tok_op = np.stack([np.where(is_ins, OP_I, OP_D),
                       np.full(n_runs, OP_M)], axis=1).ravel()
    keep = tok_len > 0
    tok_len, tok_op = tok_len[keep], tok_op[keep].astype(np.uint8)
    tok_rec = np.repeat(run_rec, 2)[keep]
    bounds = np.searchsorted(tok_rec, np.arange(n_records + 1))
    mcols = np.bincount(run_rec, weights=runs).astype(np.int64)
    tokens = np.char.add(tok_len.astype(str),
                         np.array(list("MID"))[tok_op])
    lines = []
    for r in range(n_records):
        cigar = "".join(tokens[bounds[r]: bounds[r + 1]].tolist())
        lines.append(
            f"{names[0]}\t{seq_len}\t{qs[r]}\t{qs[r] + qspan[r]}\t"
            f"{'-' if rev_rec[r] else '+'}\t{names[1]}\t{seq_len}\t{ts[r]}\t"
            f"{ts[r] + tspan[r]}\t{mcols[r]}\t{max(qspan[r], tspan[r])}\t60"
            f"\tAS:i:{2 * mcols[r]}\tcg:Z:{cigar}\n")
    return dict(runs=runs, run_rec=run_rec, rev=rev, qpos=qpos, tpos=tpos,
                n_rev=int(rev_rec.sum()), names=names, seq_len=seq_len,
                qs=qs, qspan=qspan, ts=ts, tspan=tspan, rev_rec=rev_rec,
                mcols=mcols, ops=tok_op, lens=tok_len, off=bounds,
                lines=lines)


def soft_mask(rng, seq, n_stretches, n_runs_of_n, max_n_run):
    """Runs of N, then lowercase stretches, in place."""
    n = len(seq)
    for s in rng.integers(0, n - max_n_run - 10_000, n_runs_of_n):
        seq[s: s + int(rng.integers(1_000, max_n_run))] = ord("N")
    starts = rng.integers(0, n, n_stretches)
    ends = np.minimum(starts + rng.integers(50, 3_000, n_stretches), n)
    d = np.zeros(n + 1, dtype=np.int32)
    np.add.at(d, starts, 1)
    np.add.at(d, ends, -1)
    lower = np.cumsum(d[:-1], dtype=np.int32) > 0
    seq[lower] |= 0x20


def write_fasta(fh, name, seq, width):
    fh.write(f">{name}\n".encode())
    full = len(seq) // width
    body = np.empty((full, width + 1), dtype=np.uint8)
    body[:, :width] = seq[: full * width].reshape(full, width)
    body[:, width] = ord("\n")
    fh.write(body.tobytes())
    if len(seq) % width:
        fh.write(seq[full * width:].tobytes() + b"\n")


def _mix64(x):
    """splitmix64's finalizer of uint64 ``x`` (wrapping arithmetic)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def copy_through_map(pool, lens, qpos0, tpos0, rev, keep_per_mille, seed):
    """Write the query bytes of ``pool`` in place through the alignment map:
    column i of run j takes the target byte at tpos0[j] + i (complemented
    on '-') and is written at qpos0[j] + i ('+') or qpos0[j] - i ('-');
    it is replaced by base (h >> 12) & 3 where h % 1000 >= keep_per_mille,
    h the splitmix64 finalizer of seed + c_j + i, c_j the sum of the
    earlier runs' lengths times 2654435761 (mod 2**64)."""
    lens = np.asarray(lens, dtype=np.int64)
    col = np.zeros(len(lens), dtype=np.uint64)
    np.cumsum((lens[:-1].astype(np.uint64) * np.uint64(2654435761)),
              out=col[1:])
    col += np.uint64(seed & _MASK64)
    ends = np.cumsum(lens)
    spans = list(zip(tpos0.tolist(), qpos0.tolist(), lens.tolist(),
                     np.asarray(rev, dtype=bool).tolist()))
    j0 = 0
    while j0 < len(lens):
        base = int(ends[j0] - lens[j0])
        j1 = max(int(np.searchsorted(ends, base + _COPY_CHUNK, "right")),
                 j0 + 1)
        ln = lens[j0:j1]
        start = ends[j0:j1] - ln - base
        x = np.repeat(col[j0:j1] - start.astype(np.uint64), ln)
        x += np.arange(len(x), dtype=np.uint64)
        h = _mix64(x)
        src = np.concatenate([pool[t: t + n] for t, _, n, _ in spans[j0:j1]])
        back = np.repeat(np.asarray(rev[j0:j1], dtype=bool), ln)
        src = np.where(back, COMP[src], src)
        swap = (h % np.uint64(1000)) >= np.uint64(keep_per_mille)
        src[swap] = ACGT[(h[swap] >> np.uint64(12)).astype(np.int64) & 3]
        for (_, q, n, b), a in zip(spans[j0:j1], start.tolist()):
            if b:
                pool[q - n + 1: q + 1] = src[a: a + n][::-1]
            else:
                pool[q: q + n] = src[a: a + n]
        j0 = j1


def _mask_both(rng, cfg, tseq, qseq_fill, scale, total):
    max_n_run = min(cfg["max_n_run"], total // 100)
    soft_mask(rng, tseq, int(cfg["t_mask_stretches"] * scale),
              max(int(cfg["t_runs_of_n"] * scale), 1), max_n_run)
    qseq = qseq_fill()
    soft_mask(rng, qseq, int(cfg["q_mask_stretches"] * scale),
              max(int(cfg["q_runs_of_n"] * scale), 1), max_n_run)


def build_pair(d, seed, cfg):
    """Write seqs.fa and in.paf of a ``pair`` configuration into ``d``;
    returns (fasta, paf, the synth_workload dict)."""
    rng = np.random.default_rng(seed)
    n = cfg["seq_len"]
    w = synth_workload(rng, cfg, n, cfg["n_records"], cfg["m_columns"],
                       ("q_chr", "t_chr"))
    seqs = ACGT[rng.integers(0, 4, 2 * n, dtype=np.uint8)]
    tseq, qseq = seqs[:n], seqs[n:]

    def fill():
        copy_through_map(seqs, w["runs"], w["qpos"] + n, w["tpos"], w["rev"],
                         cfg["keep_per_mille"], seed + 7)
        return qseq
    _mask_both(rng, cfg, tseq, fill, n / cfg["mask_scale_len"], n)
    fa, paf = os.path.join(d, "seqs.fa"), os.path.join(d, "in.paf")
    with open(fa, "wb") as fh:
        write_fasta(fh, "t_chr", tseq, cfg["fasta_width"])
        write_fasta(fh, "q_chr", qseq, cfg["fasta_width"])
    with open(paf, "w") as fh:
        fh.writelines(w["lines"])
    w["seqs"] = {"t_chr": tseq, "q_chr": qseq}
    return fa, paf, w


def build_genome(d, seed, cfg):
    """Write genome.fa (target contigs t_chr1.., then query contigs
    q_chr1..) and genome.paf (each contig's gapless records, contig after
    contig) of a ``genome`` configuration into ``d``; returns (fasta, paf,
    contig lengths, [synth_workload dict per contig])."""
    rng = np.random.default_rng(seed + 23)
    k = cfg["contigs"]
    seq_len = cfg["seq_len"]
    share = np.geomspace(1, cfg["spread"], k)[rng.permutation(k)]
    lens = (seq_len * share / share.sum()).astype(np.int64)
    total = int(lens.sum())
    works = [synth_workload(rng, cfg, n,
                            max(1, round(cfg["n_records"] * n / total)),
                            int(cfg["m_columns"] * n / total),
                            (f"q_chr{i + 1}", f"t_chr{i + 1}"))
             for i, n in enumerate(lens.tolist())]
    seqs = ACGT[rng.integers(0, 4, 2 * total, dtype=np.uint8)]
    tseq, qseq = seqs[:total], seqs[total:]
    shift = np.repeat(np.cumsum(lens) - lens, [len(w["runs"]) for w in works])

    def runs_of(key):
        return np.concatenate([w[key] for w in works])

    def fill():
        copy_through_map(seqs, runs_of("runs"),
                         runs_of("qpos") + shift + total,
                         runs_of("tpos") + shift, runs_of("rev"),
                         cfg["keep_per_mille"], seed + 7)
        return qseq
    _mask_both(rng, cfg, tseq, fill, total / cfg["mask_scale_len"], total)
    fa, paf = os.path.join(d, "genome.fa"), os.path.join(d, "genome.paf")
    with open(fa, "wb") as fh:
        for seq, side in ((tseq, 1), (qseq, 0)):
            for w, a, n in zip(works, np.cumsum(lens) - lens, lens):
                write_fasta(fh, w["names"][side], seq[a: a + n],
                            cfg["fasta_width"])
    with open(paf, "wb") as fh:
        for w in works:
            fh.write(chain_input(w))
    for w, a, n in zip(works, np.cumsum(lens) - lens, lens.tolist()):
        w["seqs"] = {w["names"][1]: tseq[a: a + n],
                     w["names"][0]: qseq[a: a + n]}
    return fa, paf, lens, works


def pair_inputs(cfg, seed, workdir) -> dict:
    """A pair's files (seqs.fa, in.paf, chain.paf), its gapped and gapless
    records, and its sequences by name."""
    fa, paf, w = build_pair(workdir, seed, cfg)
    chain_paf = os.path.join(workdir, "chain.paf")
    with open(chain_paf, "wb") as fh:
        fh.write(chain_input(w))
    return {"files": {"fasta": fa, "gapped": paf, "gapless": chain_paf},
            "records": {"gapped": records_of(w), "gapless": gapless_of(w)},
            "seqs": w["seqs"]}


def gapless_records(w):
    """(qstart, is '+', tstart, length, AS) arrays of the gapless records of
    the synthesis ``w``, one per M run, in order: '-' records walk down
    the query, and each has its parent's AS."""
    runs, rev = w["runs"], w["rev"]
    qs = np.where(rev, w["qpos"] - runs + 1, w["qpos"])
    score = 2 * np.bincount(w["run_rec"], weights=runs).astype(np.int64)
    return qs, ~rev, w["tpos"], runs, score[w["run_rec"]]


def chain_input(w) -> bytes:
    """One gapless record per M run of ``w``, in order: the run length in
    fields 10-11, MAPQ 60, the parent's AS, s1:i:0 and cg:Z:<len>M (the
    bytes of paffy's ``shatter`` of the gapped records)."""
    qname, tname = w["names"]
    n = w["seq_len"]
    qs, fwd, ts, ln, sc = gapless_records(w)
    strand = np.where(fwd, "+", "-")
    return "".join(
        f"{qname}\t{n}\t{q}\t{q + m}\t{s}\t{tname}\t{n}\t{t}\t"
        f"{t + m}\t{m}\t{m}\t60\tAS:i:{a}\ts1:i:0\tcg:Z:{m}M\n"
        for q, s, t, m, a in zip(qs.tolist(), strand.tolist(), ts.tolist(),
                                 ln.tolist(), sc.tolist())).encode()


def _names(values):
    a = np.empty(len(values), dtype=object)
    a[:] = values
    return a


def records_of(w) -> dict:
    """The gapped records of ``w`` (in.paf) as column arrays: qname, qlen,
    qstart, qend, fwd ('+'), tname, tlen, tstart, tend, nmatch, nbases,
    mapq, score (AS), s1 (-1: absent), and the cigar as ops, lens, off."""
    n_rec = len(w["qs"])
    qname, tname = w["names"]
    n = w["seq_len"]
    return dict(
        qname=_names([qname] * n_rec), qlen=np.full(n_rec, n),
        qstart=w["qs"], qend=w["qs"] + w["qspan"], fwd=~w["rev_rec"],
        tname=_names([tname] * n_rec), tlen=np.full(n_rec, n),
        tstart=w["ts"], tend=w["ts"] + w["tspan"], nmatch=w["mcols"],
        nbases=np.maximum(w["qspan"], w["tspan"]), mapq=np.full(n_rec, 60),
        score=2 * w["mcols"], s1=np.full(n_rec, -1),
        ops=w["ops"], lens=w["lens"], off=w["off"].astype(np.int64))


def gapless_of(w) -> dict:
    """The gapless records of ``w`` (chain_input) as ``records_of`` gives
    records: one M op each, s1 0."""
    qs, fwd, ts, ln, sc = gapless_records(w)
    m = len(qs)
    qname, tname = w["names"]
    n = w["seq_len"]
    return dict(
        qname=_names([qname] * m), qlen=np.full(m, n), qstart=qs,
        qend=qs + ln, fwd=fwd, tname=_names([tname] * m),
        tlen=np.full(m, n), tstart=ts, tend=ts + ln, nmatch=ln, nbases=ln,
        mapq=np.full(m, 60), score=sc, s1=np.zeros(m, dtype=np.int64),
        ops=np.full(m, OP_M, dtype=np.uint8), lens=ln.astype(np.int64),
        off=np.arange(m + 1, dtype=np.int64))


def concat_records(parts: list[dict]) -> dict:
    """The records of ``parts`` one after another."""
    out = {}
    for k in parts[0]:
        if k == "off":
            base = np.cumsum([0] + [int(p["off"][-1]) for p in parts[:-1]])
            out[k] = np.concatenate([parts[0]["off"]] + [
                p["off"][1:] + b for p, b in zip(parts[1:], base[1:])])
        else:
            out[k] = np.concatenate([p[k] for p in parts])
    return out
