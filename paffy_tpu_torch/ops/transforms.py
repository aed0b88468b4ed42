"""Per-record transforms over the CSR cigar store (counterpart of
paffy_tpu/ops/transforms.py: ``stats_calc_with_m`` :48-93,
``remove_mismatches`` :126, ``query_walk_violation`` :337; the reference's
paf_stats_calc impl/paf.c:236-260, paf_remove_mismatches
impl/paf.c:786-809)."""

from __future__ import annotations

import numpy as np

from paffy_tpu_torch import native
from paffy_tpu_torch.core.model import (MATCH, SEQ_MATCH, SEQ_MISMATCH,
                                        PafTable)

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
