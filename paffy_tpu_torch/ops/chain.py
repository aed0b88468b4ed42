"""Sparse chaining of PAF records (counterpart of paffy_tpu/ops/chain.py:
``_NEG`` and ``_window_bounds`` :54-88, ``_chain_strand_set`` :178-256,
``paf_chain`` and ``paf_chain_order`` :259-328; the reference's
impl/chaining.c).

Records are chained per strand set ('-' query coordinates mirrored to
negative values) and per (qname, tname) group, in ascending query start
(ties in input order), by the recurrence

  chain_score[i] = max(score[i],
                       max_j { score[i] + chain_score[j] - gap(i, j) })
  over j processed before i with qend_j <= qstart_i, tend_j <= tstart_i,
  qstart_i - qend_j <= max_gap, tstart_i - tend_j <= max_gap and
  gap(i, j) < score[i]                     (impl/chaining.c:192-199),

ties between equal values going to the largest (target end, query end,
processing index).  The candidates j of record i are one contiguous window
of the group's records sorted by query end (``_window_bounds``).  Chains
are then taken greedily, best chain score first (ties: latest processed
first), each walking its predecessor links until a claimed record; members
are written head first, chain ids in extraction order, and the chain total
is recomputed along the surviving links (impl/chaining.c:88-113, 216-233),
in one C pass per strand set (native.chain_extract) that releases the GIL.

The DP runs on the device, always: one K6 launch over the groups of both
strand sets (ops/chain_device.chain_groups_device, arguments from
``dp_arguments``; the '-' set's DP does not depend on the '+' set's, only
its chain ids do, at extraction), or with ``dp_many`` = chain_groups_device
over a mesh, one launch per data row of the mesh.  There is no per-group
host route and no size routing; the C DP (native.chain_dp) is a reference
for the tests and chip_smoke.py.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from paffy_tpu_torch import native, phases
from paffy_tpu_torch.core.model import PafTable
from paffy_tpu_torch.core.pafio import paf_check
from paffy_tpu_torch.ops.chain_device import chain_groups_device

_NEG = np.int64(-(1 << 62))


def _window_bounds(qs, qe, max_gap):
    """Candidate windows in query-end order: (qe_order, lo, hi), the
    query-end sort (ties by processing index) and each record's candidate
    slice [lo, hi) of it.  A predecessor's query end lies in
    [qstart_i - max_gap, qstart_i] (the reference's query-gap skip and
    evict rules, impl/chaining.c:174-183); query starts ascend, so what
    falls below a window never comes back."""
    n = len(qs)
    qe_order = np.lexsort((np.arange(n), qe))
    qes = qe[qe_order]
    lo = np.searchsorted(qes, qs - max_gap, side="left")
    hi = np.searchsorted(qes, qs, side="right")
    return qe_order, lo, np.maximum(hi, lo)


def dp_arguments(groups, max_gap: int) -> tuple[np.ndarray, ...]:
    """K6's arguments for ``groups``, a list of (qs, qe, ts, te, score)
    int64 arrays with each group's records in processing order: (goff, qs,
    ts, score, qe_s, te_s, idx_s, lo, w, pos), the groups laid end to end
    in slots goff[g]..goff[g+1] (see ops/chain_device).  Every index is a
    slot: idx_s is each query-end slot's record, lo and pos are slots of
    the query-end order, so no window crosses a group."""
    sizes = np.array([len(g[0]) for g in groups], dtype=np.int64)
    goff = np.zeros(len(groups) + 1, dtype=np.int64)
    np.cumsum(sizes, out=goff[1:])
    n = int(goff[-1])

    def cat(k):
        return (np.concatenate([g[k] for g in groups]).astype(np.int64)
                if groups else np.zeros(0, dtype=np.int64))
    qe_s, te_s, idx_s, lo, w, pos = (np.empty(n, dtype=np.int64)
                                     for _ in range(6))
    for (qs, qe, ts, te, score), c0, m in zip(groups, goff[:-1], sizes):
        qe_order, glo, ghi = _window_bounds(qs, qe, max_gap)
        sl = slice(c0, c0 + m)
        qe_s[sl], te_s[sl] = qe[qe_order], te[qe_order]
        idx_s[sl] = c0 + qe_order
        lo[sl], w[sl] = c0 + glo, ghi - glo
        pos[c0 + qe_order] = np.arange(c0, c0 + m)
    return goff, cat(0), cat(2), cat(4), qe_s, te_s, idx_s, lo, w, pos


def _strand_set_groups(t: PafTable, sel, qs, qe, ts, te):
    """The records ``sel`` of one strand set in processing order, grouped
    by (qname, tname): (idx, perm, goff, cols, groups) with idx[k] the
    record at processing position k, perm the processing positions group
    by group (group g at perm[goff[g]:goff[g+1]], in processing order),
    cols the set's (qs, qe, ts, te, score) in processing order and groups
    those of each group."""
    # ascending query start, ties in input order (paf_cmp_by_query_location
    # with its pointer tiebreak, impl/chaining.c:14-21; sel ascends)
    idx = sel[np.argsort(qs[sel], kind="stable")]
    gid, keys, key_runs = native.first_seen_ids(t.qname[idx], t.tname[idx])
    phases.count(key_runs=key_runs)
    perm, goff = native.id_groups(gid, len(keys))
    cols = [a[idx] for a in (qs, qe, ts, te, t.score)]
    groups = [tuple(c[perm[a:b]] for c in cols)
              for a, b in zip(goff[:-1], goff[1:])]
    return idx, perm, goff, cols, groups


def _extract_set(idx, perm, goff, cols, results, gap_open: int,
                 gap_extend: int, first_id: int):
    """The chains of one strand set from its groups' DP ``results`` (a list
    of (chain_score, pred) per group of ``_strand_set_groups``' (idx,
    perm, goff, cols)), by native.chain_extract: (the records in output
    order, their chain ids, their chain scores, the next chain id)."""
    n = len(idx)
    if n == 0:
        return (np.zeros(0, dtype=np.int64),) * 3 + (first_id,)
    # the groups' results back to processing positions; a group-local
    # predecessor is a slot of its group in perm
    cs = np.empty(n, dtype=np.int64)
    pred = np.empty(n, dtype=np.int64)
    gpred = np.concatenate([p for _, p in results])
    slot = np.maximum(gpred, 0) + np.repeat(goff[:-1], np.diff(goff))
    cs[perm] = np.concatenate([c for c, _ in results])
    pred[perm] = np.where(gpred >= 0, perm[slot], -1)
    members, ids, scores, nxt = native.chain_extract(
        cs, pred, *cols, gap_open, gap_extend, first_id)
    phases.count(records=n, chains=nxt - first_id)
    return idx[members], ids, scores, nxt


def _chain_coordinates(t: PafTable, pct_trim: float):
    """(qs, qe, ts, te) of the records as the chaining sees them: trimmed
    by pct_trim (impl/chaining.c:274-289; the C computes span * pct in
    float32, truncates, then halves the smaller), '-' strand query
    coordinates mirrored (invert_query_strand, impl/chaining.c:255-259)."""
    if not 0.0 <= pct_trim <= 1.0:
        raise AssertionError()     # as paffy_tpu's assert in paf_chain_order
    q_span = (t.qend - t.qstart).astype(np.float32)
    t_span = (t.tend - t.tstart).astype(np.float32)
    maxq = np.trunc(q_span * np.float32(pct_trim)).astype(np.int64)
    maxt = np.trunc(t_span * np.float32(pct_trim)).astype(np.int64)
    trim = np.minimum(maxq, maxt) // 2
    neg = ~t.strand
    qs = np.where(neg, -(t.qend - trim), t.qstart + trim)
    qe = np.where(neg, -(t.qstart + trim), t.qend - trim)
    return qs, qe, t.tstart + trim, t.tend - trim


def chain_groups(t: PafTable, pct_trim: float = 1.0) -> list[list[tuple]]:
    """The DP groups of the '+' and of the '-' strand set of ``t``, as
    ``paf_chain_order`` hands them, '+' first, to one K6 launch (for checks
    against the C DP)."""
    coords = _chain_coordinates(t, pct_trim)
    return [_strand_set_groups(t, sel, *coords)[-1]
            for sel in (np.flatnonzero(t.strand), np.flatnonzero(~t.strand))]


def paf_chain(t: PafTable, gap_open: int = 5000, gap_extend: int = 1,
              max_gap: int = 1000000, pct_trim: float = 1.0,
              dp_many=None) -> PafTable:
    """Chain a batch of records (paf_chain, impl/chaining.c:266-343); the
    default costs are paffy chain's (impl/paf_chain.c:17-20,36-45).
    ``dp_many`` replaces the DP solver (see paf_chain_order)."""
    tagged, perm = paf_chain_order(t, gap_open=gap_open,
                                   gap_extend=gap_extend, max_gap=max_gap,
                                   pct_trim=pct_trim, dp_many=dp_many)
    return tagged.take(perm) if perm is not None else tagged


def paf_chain_order(t: PafTable, gap_open: int = 5000, gap_extend: int = 1,
                    max_gap: int = 1000000, pct_trim: float = 1.0,
                    dp_many=None):
    """paf_chain without reordering the table: (tagged, perm), the input
    with its cn and s1 tags set, in input order, and the output order
    (descending score, stable, impl/chaining.c:337).  Writing ``tagged``
    in ``perm`` order gives paf_chain's bytes without copying the cigars.
    ``dp_many`` solves the DP of a list of (qs, qe, ts, te, score) groups
    into a list of (chain_score, pred) (default: chain_groups_device, one
    K6 launch on devconf.device()); it is called once, with the groups of
    both strand sets."""
    coords = _chain_coordinates(t, pct_trim)
    n = len(t)
    if n == 0:
        return t, None
    with phases.timed("window"):
        sets = [_strand_set_groups(t, sel, *coords)
                for sel in (np.flatnonzero(t.strand),
                            np.flatnonzero(~t.strand))]
    # one DP call over both strand sets' groups, '+' first
    results = (dp_many or chain_groups_device)(
        [g for s in sets for g in s[-1]], gap_open, gap_extend, max_gap)
    outs, nxt = [], 0
    with phases.timed("extract"):
        for *grouping, groups in sets:
            *out, nxt = _extract_set(*grouping, results[: len(groups)],
                                     gap_open, gap_extend, nxt)
            results = results[len(groups):]
            outs.append(out)
    order, ids, scores = (np.concatenate(x) for x in zip(*outs))
    # the tags go back to the input positions (the reference sets them on
    # the records in place, chain_to_pafs :115-131)
    cid = np.full(n, -1, dtype=np.int64)
    cscore = np.full(n, -1, dtype=np.int64)
    cid[order] = ids
    cscore[order] = scores
    tagged = replace(t, chain_id=cid, chain_score=cscore)
    paf_check(tagged)
    # descending score, stable over the strand sets' concatenation
    return tagged, order[np.argsort(-tagged.score[order], kind="stable")]
