"""The plain reference of ``paffy tile`` on one genome's whole PAF
(perfbench/synth_deep.py's deployment): perfbench/reference.py's
``tile`` and ``serialize``, with the levels computed a block at a time
so that records stacked thousands deep fit in time and memory.

A block is a connected run of overlapping query spans, the query
sequences laid end to end: a base's count depends only on the records
that cover it, all of one block, so each block's levels are
``reference.tile_levels`` of its records alone, taken in the global
best-first order.  Blocks are handed to it whole, several at a time, up
to about CHUNK records a call, THREADS calls at once.

Imports nothing of the program under test.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import reference

CHUNK = 1 << 12             # records per tile_levels call, whole blocks
THREADS = min(8, os.cpu_count() or 1)   # calls at once (NumPy drops the GIL)
CONTROL_CAP = 255           # the control's saturation: 8-bit counts


def _csr(counts):
    off = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    return off


def intervals(recs: dict) -> int:
    """The stretches of aligned query bases the records hold, one per
    maximal run of a record's touching aligned ops (an insertion parts
    two, a deletion does not): what K5 reads an interval each."""
    rec = np.repeat(np.arange(len(recs["off"]) - 1), np.diff(recs["off"]))
    ops, lens = recs["ops"], recs["lens"]
    q_adv = np.where(ops != reference.OP_D, lens, 0)
    s = np.cumsum(q_adv) - q_adv
    aligned = (ops != reference.OP_I) & (ops != reference.OP_D) & (lens > 0)
    rec, s, e = rec[aligned], s[aligned], s[aligned] + lens[aligned]
    joined = (rec[1:] == rec[:-1]) & (s[1:] == e[:-1])
    return int(len(rec) - np.count_nonzero(joined))


def blocks(recs: dict) -> tuple[np.ndarray, np.ndarray]:
    """(records by query start, offsets of the blocks among them): each
    block a connected run of overlapping [qstart, qend) spans, the query
    sequences end to end in first-seen order."""
    _, first, seq_of = np.unique(recs["qname"], return_index=True,
                                 return_inverse=True)
    rank = np.empty(len(first), dtype=np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    seq_of = rank[seq_of]
    qlen = np.zeros(len(first), dtype=np.int64)
    qlen[seq_of] = recs["qlen"]
    base = _csr(qlen)[:-1][seq_of]
    lo, hi = recs["qstart"] + base, recs["qend"] + base
    by = np.argsort(lo, kind="stable")
    reach = np.maximum.accumulate(hi[by])
    new = np.ones(len(by), dtype=bool)
    new[1:] = lo[by][1:] >= reach[:-1]
    return by, np.append(np.flatnonzero(new), len(by))


def tile_levels(recs: dict, order) -> np.ndarray:
    """``reference.tile_levels(recs, order)``, block by block."""
    n = len(recs["qstart"])
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    levels = np.full(n, reference.EMPTY_TILE_LEVEL, dtype=np.int64)
    by, cuts = blocks(recs)
    # each call takes the blocks that start in one window of CHUNK records
    calls = np.unique(cuts[:-1] // CHUNK, return_index=True)[1]

    def call(a, b):
        idx = by[a:b]
        idx = idx[np.argsort(rank[idx])]
        levels[idx] = reference.tile_levels(reference.take(recs, idx),
                                            np.arange(len(idx)))
    with ThreadPoolExecutor(THREADS) as pool:
        list(pool.map(call, cuts[calls], np.append(cuts[calls][1:], n)))
    return levels


def tile_jobs(recs: dict, seqs: dict, keys, control=False):
    """({"whole": bytes}, {"whole": [work of its K5 sweep]}) of ``paffy
    tile`` on the records: records and intervals (``intervals``).
    ``control`` keeps the counts in 8 bits, saturating at CONTROL_CAP, not
    at paffy's 32,766: a record's median count is then its level capped
    there (the cap is monotone, so it commutes with the median)."""
    n = len(recs["qstart"])
    order = np.lexsort((np.arange(n), -recs["score"], -recs["s1"]))
    levels = tile_levels(recs, order)
    if control:
        levels = np.where(levels == reference.EMPTY_TILE_LEVEL, levels,
                          np.minimum(levels, CONTROL_CAP))
    out = dict(recs, tl=levels)
    data = reference.serialize(reference.take(out, order))
    work = {"records": n, "intervals": intervals(recs)}
    return ({k: data for k in keys if k == "whole"},
            {k: [work] for k in keys if k == "whole"})
