"""Per-record transforms over the CSR cigar store (counterpart of
paffy_tpu/ops/transforms.py: ``stats_calc_with_m`` :48-93, ``stats_calc``
:71, ``invert`` :96, ``remove_mismatches`` :126, the fixed end trim
``trim_ends`` :220 and ``trim_end_fraction`` :251 with their helpers,
``shatter`` :265, ``query_walk_violation`` :337, ``shatter_violation``
:403; the reference's paf_stats_calc impl/paf.c:236-260, paf_invert
impl/paf.c:469-490, paf_remove_mismatches impl/paf.c:786-809,
paf_trim_ends and paf_trim_end_fraction impl/paf.c:518-598, paf_shatter
impl/paf.c:600-663)."""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from paffy_tpu_torch import native
from paffy_tpu_torch.core.model import (MATCH, QUERY_DELETE, QUERY_INSERT,
                                        SEQ_MATCH, SEQ_MISMATCH, PafTable)
from paffy_tpu_torch.core.segsum import (segment_ids_from_offsets,
                                         segment_sums_by_offsets)

STAT_KEYS = ("matches", "mismatches", "query_inserts", "query_deletes",
             "query_insert_bases", "query_delete_bases")

_ALIGNED = np.zeros(5, dtype=bool)
_ALIGNED[[MATCH, SEQ_MATCH, SEQ_MISMATCH]] = True


def stats_calc_with_m(t: PafTable) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Per-record stats (matches count M and = bases, mismatches X bases,
    inserts/deletes as events and as bases) and the M-only base counts, in
    one native pass (tokenized from the cg text for a raw-cigar table)."""
    if t.raw_cg is not None:
        out = native.cigar_stats_raw(t)
    else:
        out = native.cigar_stats(len(t), t.ops, t.lens, t.off)
    return ({k: np.ascontiguousarray(out[:, i])
             for i, k in enumerate(STAT_KEYS)},
            np.ascontiguousarray(out[:, 6]))


def stats_calc(t: PafTable) -> dict[str, np.ndarray]:
    """Per-record stats without the M-only counts (paf_stats_calc)."""
    return stats_calc_with_m(t)[0]


def aligned_base_counts(t: PafTable) -> np.ndarray:
    """Per-record aligned bases, the sum of M/=/X run lengths
    (paf_get_number_of_aligned_bases, impl/paf.c:507-516)."""
    return segment_sums_by_offsets(np.where(_ALIGNED[t.ops], t.lens, 0),
                                   t.off)


def invert(t: PafTable) -> PafTable:
    """Query and target swapped, I and D swapped, and the ops of each '-'
    record reversed (paf_invert), the cigar half in one native pass."""
    ops, lens = t.ops, t.lens
    if len(t.ops):
        ops, lens = native.invert_ops(t.off, t.ops, t.lens, ~t.strand)
    return replace(
        t, qname=t.tname, qlen=t.tlen, qstart=t.tstart, qend=t.tend,
        tname=t.qname, tlen=t.qlen, tstart=t.qstart, tend=t.qend,
        ops=ops, lens=lens)


def remove_mismatches(t: PafTable) -> PafTable:
    """Merge each stretch of consecutive M/=/X ops of a record into one M
    op; I and D ops stay as they are, unmerged (paf_remove_mismatches)."""
    if len(t.ops) == 0:
        return t
    ops = np.where(_ALIGNED[t.ops], np.uint8(MATCH), t.ops)
    seg = np.repeat(np.arange(len(t), dtype=np.int64), np.diff(t.off))
    first = np.ones(len(ops), dtype=bool)
    first[1:] = seg[1:] != seg[:-1]
    prev_m = np.zeros(len(ops), dtype=bool)
    prev_m[1:] = ops[:-1] == MATCH
    # an output op starts unless this is an M continuing an M
    boundary = first | (ops != MATCH) | ~prev_m
    starts = np.flatnonzero(boundary)
    new_lens = np.add.reduceat(t.lens, starts)
    new_off = np.zeros(len(t) + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg[starts], minlength=len(t)), out=new_off[1:])
    return t.with_cigars(ops[starts], new_lens, new_off)


def _front_trim_plan(ops, lens, off, targets):
    """Front-trim plan on a CSR store (cigar_trim, impl/paf.c:518-545):
    leading ops are consumed while they are not aligned or the aligned
    bases consumed so far are below the record's target; an aligned op
    that spans the target is cut.  Returns (keep mask over the flat ops,
    per-op length reduction, per-record query and target bases consumed).
    """
    total = len(ops)
    if total == 0:
        z = np.zeros(len(off) - 1, dtype=np.int64)
        return np.ones(0, dtype=bool), np.zeros(0, dtype=np.int64), z, z.copy()
    seg = segment_ids_from_offsets(off, total)
    aligned = _ALIGNED[ops]
    al = np.where(aligned, lens, 0)
    c = np.cumsum(al)
    seg_base = np.concatenate([[0], c])[off[:-1]]
    a_incl = c - seg_base[seg]    # aligned bases up to and with this op
    a_excl = a_incl - al
    tgt = targets[seg]
    # the stop op: the first aligned op with a_excl + len > target
    stop = aligned & (a_incl > tgt)
    # an op before the stop op is consumed, indels at the boundary too
    consumed = np.where(aligned, a_incl <= tgt, a_excl <= tgt) & ~stop
    partial = np.where(stop, np.maximum(tgt - a_excl, 0), 0)
    dq = np.where(consumed & (ops != QUERY_DELETE), lens, 0) + partial
    dt = np.where(consumed & (ops != QUERY_INSERT), lens, 0) + partial
    return (~consumed, partial, segment_sums_by_offsets(dq, off),
            segment_sums_by_offsets(dt, off))


def _apply_plan(ops, lens, off, keep, reduce_by):
    new_ops = ops[keep]
    new_lens = (lens - reduce_by)[keep]
    per_rec = np.zeros(len(off) - 1, dtype=np.int64)
    if len(ops):
        np.add.at(per_rec, segment_ids_from_offsets(off, len(ops))[keep], 1)
    new_off = np.zeros(len(off), dtype=np.int64)
    np.cumsum(per_rec, out=new_off[1:])
    return new_ops, new_lens, new_off


def _reverse_csr(ops, lens, off):
    """Each record's ops in reverse order."""
    if len(ops) == 0:
        return ops, lens
    seg = segment_ids_from_offsets(off, len(ops))
    pos = np.arange(len(ops), dtype=np.int64) - off[seg]
    cnt = off[1:] - off[:-1]
    perm = off[seg] + (cnt[seg] - 1 - pos)
    return ops[perm], lens[perm]


def trim_ends(t: PafTable, bases) -> PafTable:
    """Trim ``bases`` aligned bases (and the indels at the cut) from each
    end of every record (paf_trim_ends, impl/paf.c:578-587), with the
    reference's strand-dependent coordinate updates."""
    targets = np.broadcast_to(np.asarray(bases, dtype=np.int64),
                              (len(t),)).copy()
    keep, red, dq_f, dt_f = _front_trim_plan(t.ops, t.lens, t.off, targets)
    ops1, lens1, off1 = _apply_plan(t.ops, t.lens, t.off, keep, red)
    # the back: reverse each record, trim its front, reverse back
    rops, rlens = _reverse_csr(ops1, lens1, off1)
    keep_b, red_b, dq_b, dt_b = _front_trim_plan(rops, rlens, off1, targets)
    ops2r, lens2r, off2 = _apply_plan(rops, rlens, off1, keep_b, red_b)
    ops2, lens2 = _reverse_csr(ops2r, lens2r, off2)
    s = t.strand
    # same strand: front -> qstart, tstart; back -> qend, tend
    # opposite:    front -> qend, tstart;   back -> qstart, tend
    return replace(t, qstart=t.qstart + np.where(s, dq_f, dq_b),
                   qend=t.qend - np.where(s, dq_b, dq_f),
                   tstart=t.tstart + dt_f, tend=t.tend - dt_b,
                   ops=ops2.astype(np.uint8), lens=lens2.astype(np.int64),
                   off=off2.astype(np.int64))


def trim_end_fraction(t: PafTable, percentage: float) -> PafTable:
    """paf_trim_end_fraction (impl/paf.c:589-598): trim
    trunc(float32(aligned bases * percentage) / 2.0) bases from each end."""
    if not 0.0 <= percentage <= 1.0:
        raise AssertionError()     # as paffy_tpu's assert, impl/paf.c:589-598
    ab = aligned_base_counts(t)
    # C: int64 * float in float32, / 2.0 in double, truncated to int64
    per_end = np.trunc((ab.astype(np.float32) * np.float32(percentage))
                       .astype(np.float64) / 2.0).astype(np.int64)
    return trim_ends(t, per_end)


def query_walk_violation(t: PafTable, seen_qlens: dict | None = None) -> int:
    """First record that breaks the reference's query-side coverage-walk
    asserts, or -1 (tile and to_bed buffer all output until after the walk,
    so an assert aborts with nothing written; impl/paf.c:686-709,
    impl/paf_tile.c:44-60): every aligned column inside [0, qend) and
    [0, qlen), the walk ending at qend (one native pass), and, with
    ``seen_qlens`` (mutated across batches), one query length per name."""
    n = len(t)
    if n == 0:
        return -1
    walk = native.query_walk_violation(t)
    bad = walk if walk >= 0 else n
    if seen_qlens is not None:
        uniq, first_idx, inv = np.unique(t.qname, return_index=True,
                                         return_inverse=True)
        expected = np.array([seen_qlens.setdefault(nm, int(t.qlen[i]))
                             for nm, i in zip(uniq, first_idx)],
                            dtype=np.int64)
        nb = np.flatnonzero(t.qlen != expected[inv])
        if len(nb):
            bad = min(bad, int(nb[0]))
    return -1 if bad == n else bad


def shatter(t: PafTable) -> PafTable:
    """Every M op as a gapless record of its own (paf_shatter): the
    parent's names, lengths, strand, mapq, score, tile level, type and
    chain id, chain_score 0 (the reference's calloc'd default), the run
    length as matches and bases, and a '-' record's shards walking down the
    query from qend; the coordinate walk in one native pass."""
    if np.any((t.ops == SEQ_MATCH) | (t.ops == SEQ_MISMATCH)):
        raise ValueError("paf shatter requires M-encoded cigars (no =/X runs)")
    if len(t.ops) == 0:
        return PafTable.empty()
    m_base = np.zeros(len(t) + 1, dtype=np.int64)
    np.cumsum(segment_sums_by_offsets((t.ops == MATCH).astype(np.int64),
                                      t.off), out=m_base[1:])
    k = int(m_base[-1])
    rec, q_m, t_m, ln = native.shatter_walk(t.off, t.ops, t.lens, t.qstart,
                                            t.qend, t.tstart, t.strand,
                                            m_base[:-1], k)
    return PafTable(
        qname=t.qname[rec], qlen=t.qlen[rec], qstart=q_m, qend=q_m + ln,
        strand=t.strand[rec], tname=t.tname[rec], tlen=t.tlen[rec],
        tstart=t_m, tend=t_m + ln, num_matches=ln.copy(),
        num_bases=ln.copy(), mapq=t.mapq[rec], score=t.score[rec],
        tile_level=t.tile_level[rec], chain_id=t.chain_id[rec],
        chain_score=np.zeros(k, dtype=np.int64), type=t.type[rec],
        has_cigar=np.ones(k, dtype=bool),
        ops=np.full(k, MATCH, dtype=np.uint8), lens=ln.astype(np.int64),
        off=np.arange(k + 1, dtype=np.int64))


def shatter_violation(t: PafTable):
    """(kind, record) of the first record the reference's shatter dies on,
    or (None, -1), in one native pass.  Its walk asserts that every op has
    length >= 1 and is M, I or D, and that the walk ends on the record's
    end coordinates: kind "abort" (SIGABRT, the stdio tail is lost); and it
    paf_checks every M shard it builds: kind "check" (st_errAbort, the
    tail is flushed) (impl/paf.c:600-663, the shard check at :624)."""
    if len(t) == 0 or len(t.ops) == 0:
        return None, -1
    return native.shatter_violation(t)
