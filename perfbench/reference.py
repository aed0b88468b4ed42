"""The plain reference of the benchmark's jobs: paffy's ``add_mismatches``
and its per-contig pipeline ``add_mismatches | chain | tile | trim``
(upstream tests/paf_pipeline_test.sh), in NumPy, from the records and
sequences the generator made (perfbench/synth.py), to the bytes of the
PAF lines paffy writes.

It follows paffy's C (impl/paf.c, impl/chaining.c, impl/paf_tile.c) and
imports nothing of the program under test.  Records are dicts of column
arrays (``synth.records_of``); a cigar is CSR: ops, lens, off.

* ``encode`` (add_mismatches): every M op becomes the runs of '=' and 'X'
  of its columns, a column matching when the upper-cased target byte
  equals the upper-cased query byte, complemented on '-', where the query
  walks down from qend; an M op of length 0 leaves nothing.
* ``chain``: records per strand set ('-' query coordinates mirrored),
  per (query, target) pair, in ascending query start; the chain DP of
  impl/chaining.c:150-214 with its tie-break; greedy extraction, best
  first; chain ids and totals along the surviving links.
* ``tile``: best first by (chain score, score); each record's level is the
  median of the saturating per-base counts it leaves on its aligned query
  bases (impl/paf_tile.c:36-93).
* ``trim``: the unreliable-tail trim of impl/paf.c:811-953, with its mixed
  float32 / double arithmetic; ``precision`` lowers it for the control.
* ``serialize``: paf_print's fields and tags (impl/paf.c:317-389).
"""

from __future__ import annotations

import numpy as np

OP_M, OP_I, OP_D, OP_EQ, OP_X = range(5)
OP_CHARS = np.frombuffer(b"MID=X", dtype=np.uint8)
SATURATION = 32766          # per-base counts stop here (impl/paf.c:700)
EMPTY_TILE_LEVEL = 32767    # the level of a record with no aligned base
INT_MAX = 2147483647        # "no score" (impl/paf.c:349)
GAP_OPEN, GAP_EXTEND, MAX_GAP = 5000, 1, 1_000_000  # paffy chain's defaults
TRIM_IDENTITY, TRIM_FRACTION = 0.05, 1.0            # the pipeline's trim

UPPER = np.arange(256, dtype=np.uint8)
UPPER[ord("a"): ord("z") + 1] -= 32
COMP = np.arange(256, dtype=np.uint8)
COMP[np.frombuffer(b"acgtmrwsykvhdbnxACGTMRWSYKVHDBNX", dtype=np.uint8)] = (
    np.frombuffer(b"tgcakywsrmbdhvnxTGCAKYWSRMBDHVNX", dtype=np.uint8))
UPPER_COMP = UPPER[COMP]

_CHUNK = 1 << 23            # columns compared per NumPy pass


def _seg_ids(off):
    """The record of each cigar op of CSR offsets ``off``."""
    return np.repeat(np.arange(len(off) - 1), np.diff(off))


def _csr(counts):
    off = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    return off


def take(recs: dict, idx) -> dict:
    """The records ``idx`` of ``recs``, in that order."""
    idx = np.asarray(idx, dtype=np.int64)
    a, b = recs["off"][idx], recs["off"][idx + 1]
    off = _csr(b - a)
    pos = np.repeat(a - off[:-1], b - a) + np.arange(off[-1])
    out = {k: v[idx] for k, v in recs.items()
           if k not in ("ops", "lens", "off")}
    out.update(ops=recs["ops"][pos], lens=recs["lens"][pos], off=off)
    return out


# ------------------------------------------------------------------ encode

def _op_positions(recs):
    """Per cigar op: its record, and the query and target offsets of its
    first column from the record's qstart and tstart."""
    rec = _seg_ids(recs["off"])
    ops, lens = recs["ops"], recs["lens"]
    q_adv = np.where(ops != OP_D, lens, 0)
    t_adv = np.where(ops != OP_I, lens, 0)
    first = recs["off"][:-1][rec]

    def before(adv):
        c = np.cumsum(adv) - adv
        return c - c[first]
    return rec, before(q_adv), before(t_adv)


def encode(recs: dict, seqs: dict, upper=UPPER, upper_comp=UPPER_COMP) -> dict:
    """add_mismatches: ``recs`` with every M op replaced by its =/X runs.
    ``seqs`` maps each name to its bytes (uint8)."""
    rec, qoff, toff = _op_positions(recs)
    ops, lens = recs["ops"], recs["lens"]
    mops = np.flatnonzero((ops == OP_M) & (lens > 0))
    r = rec[mops]
    fwd = recs["fwd"][r]
    tpos = recs["tstart"][r] + toff[mops]
    # a '-' op's query walks down from its first column p, which is
    # position len - 1 - p of the reverse complement, walking up
    qlen = recs["qlen"][r]
    qpos = np.where(fwd, recs["qstart"][r] + qoff[mops],
                    qlen - recs["qend"][r] + qoff[mops])
    up = {n: upper[seqs[n]] for n in
          set(recs["qname"][r][fwd].tolist()) | set(recs["tname"].tolist())}
    rc = {n: upper_comp[seqs[n][::-1]]
          for n in set(recs["qname"][r][~fwd].tolist())}
    mlen = lens[mops]
    ends = np.cumsum(mlen)
    spans = list(zip(recs["tname"][r].tolist(), tpos.tolist(),
                     recs["qname"][r].tolist(), qpos.tolist(),
                     mlen.tolist(), fwd.tolist()))
    run_op, run_len, run_mop = [], [], []
    j0 = 0
    while j0 < len(mops):
        b0 = int(ends[j0] - mlen[j0])
        j1 = max(int(np.searchsorted(ends, b0 + _CHUNK, "right")), j0 + 1)
        part = spans[j0:j1]
        t = np.concatenate([up[tn][a: a + n] for tn, a, _, _, n, _ in part])
        q = np.concatenate([(up if f else rc)[qn][a: a + n]
                            for _, _, qn, a, n, f in part])
        same = t == q
        # a run starts at each op's first column and where same changes
        start = np.ones(len(t), dtype=bool)
        start[1:] = same[1:] != same[:-1]
        first = ends[j0:j1] - mlen[j0:j1] - b0
        start[first] = True
        at = np.flatnonzero(start)
        run_op.append(np.where(same[at], OP_EQ, OP_X).astype(np.uint8))
        run_len.append(np.diff(np.append(at, len(t))))
        run_mop.append(j0 + np.searchsorted(first, at, side="right") - 1)
        j0 = j1
    run_op = np.concatenate(run_op) if run_op else np.zeros(0, np.uint8)
    run_len = (np.concatenate(run_len) if run_len
               else np.zeros(0, np.int64))
    run_mop = (np.concatenate(run_mop) if run_mop
               else np.zeros(0, np.int64))
    # every op becomes its runs (M), nothing (an empty M) or itself
    per_mop = np.bincount(run_mop, minlength=len(mops))
    n_out = np.where(ops == OP_M, 0, 1).astype(np.int64)
    n_out[mops] = per_mop
    out_off = _csr(n_out)
    new_ops = np.empty(out_off[-1], dtype=np.uint8)
    new_lens = np.empty(out_off[-1], dtype=np.int64)
    keep = np.flatnonzero(ops != OP_M)
    new_ops[out_off[keep]] = ops[keep]
    new_lens[out_off[keep]] = lens[keep]
    slot = out_off[mops][run_mop] + (np.arange(len(run_mop))
                                     - _csr(per_mop)[:-1][run_mop])
    new_ops[slot] = run_op
    new_lens[slot] = run_len
    out = dict(recs)
    out.update(ops=new_ops, lens=new_lens, off=out_off[recs["off"]])
    return out


# ------------------------------------------------------------------- chain

def _chain_coords(recs):
    """Query and target intervals as the chaining sees them: trimmed by
    pct_trim 1.0 in float32, '-' query coordinates mirrored."""
    qspan = (recs["qend"] - recs["qstart"]).astype(np.float32)
    tspan = (recs["tend"] - recs["tstart"]).astype(np.float32)
    trim = np.minimum(np.trunc(qspan * np.float32(1.0)).astype(np.int64),
                      np.trunc(tspan * np.float32(1.0)).astype(np.int64)) // 2
    fwd = recs["fwd"]
    qs = np.where(fwd, recs["qstart"] + trim, -(recs["qend"] - trim))
    qe = np.where(fwd, recs["qend"] - trim, -(recs["qstart"] + trim))
    return qs, qe, recs["tstart"] + trim, recs["tend"] - trim


def chain_dp(qs, qe, ts, te, score, go=GAP_OPEN, ge=GAP_EXTEND, mg=MAX_GAP):
    """(chain score, predecessor or -1) of records in processing order:
    the best of score[i] and score[i] + cs[j] - gap(i, j) over j < i with
    qe[j] <= qs[i], 0 <= ts[i] - te[j] <= mg, qs[i] - qe[j] <= mg and
    gap(i, j) < score[i], gap = 0 where qs[i] + ts[i] == qe[j] + te[j],
    else go + ge * (qs[i] + ts[i] - qe[j] - te[j]); ties to the largest
    (te, qe, j).

    With a gap, the value is cs[j] + ge * (qe[j] + te[j]) less a term of i
    alone, so each record's best is one maximum, over its candidates, of
    K[j] = (cs[j] + ge * (qe[j] + te[j])) * n + rank(j), rank ordering the
    records by (te, qe, j): the largest key is the best value with paffy's
    tie-break.  A record with a candidate at gap 0 takes the long way."""
    n = len(qs)
    if ge <= 0:
        raise ValueError("the gap extension cost must be positive")
    order = np.lexsort((np.arange(n), qe))
    qe_o, te_o = qe[order], te[order]
    lo = np.searchsorted(qe_o, qs - mg, side="left")
    hi = np.maximum(np.searchsorted(qe_o, qs, side="right"), lo)
    by_rank = np.lexsort((np.arange(n), qe, te))
    rank = np.empty(n, dtype=np.int64)
    rank[by_rank] = np.arange(n)
    sq = qs + ts
    s_o = qe_o + te_o
    big = int(np.abs(score).sum()) + ge * (int(np.abs(s_o).max(initial=0))
                                           + int(np.abs(sq).max(initial=0))
                                           + 2 * mg) + go + 1
    if big * max(n, 1) >= 1 << 62:
        raise OverflowError("chain keys would pass 64 bits")
    cs = score.copy()
    pred = np.full(n, -1, dtype=np.int64)
    key = (score[order] + ge * s_o) * n + rank[order]
    slot = np.empty(n, dtype=np.int64)
    slot[order] = np.arange(n)
    # the records with a candidate at gap 0: same qe + te as their qs + ts
    by_s = np.argsort(s_o, kind="stable")
    a = np.searchsorted(s_o[by_s], sq, side="left")
    b = np.searchsorted(s_o[by_s], sq, side="right")
    zero = set()
    for i in np.flatnonzero(b > a).tolist():
        k = by_s[a[i]: b[i]]
        if ((k >= lo[i]) & (k < hi[i]) & (order[k] < i)).any():
            zero.add(i)
    # the least qe + te at which the gap stays below the score
    floor_s = sq - (score - go - 1) // ge
    mgu = np.uint64(mg)
    lo_l, hi_l, ts_l, fs_l = (x.tolist() for x in (lo, hi, ts, floor_s))
    sc_l, sq_l, by_rank_l = score.tolist(), sq.tolist(), by_rank.tolist()
    for i in np.flatnonzero(hi > lo).tolist():
        a, b = lo_l[i], hi_l[i]
        if i in zero:
            v, at = _dp_slow(i, order[a:b], qs, qe_o[a:b], ts, te_o[a:b],
                             score, cs, rank, n, go, ge, mg)
        else:
            m = (ts_l[i] - te_o[a:b]).view(np.uint64) <= mgu
            m &= s_o[a:b] >= fs_l[i]
            m &= order[a:b] < i
            k = key[a:b][m]
            if not len(k):
                continue
            v, at = divmod(int(k.max()) - n * (go + ge * sq_l[i]), n)
        if v > 0:
            cs[i] = sc_l[i] + v
            pred[i] = by_rank_l[at]
            key[slot[i]] = (cs[i] + ge * (qe[i] + te[i])) * n + rank[i]
    return cs, pred


def _dp_slow(i, j, qs, qe_w, ts, te_w, score, cs, rank, n, go, ge, mg):
    """(value, rank) of record i's best candidate among ``j`` (its window),
    the gap worked out candidate by candidate."""
    tg = ts[i] - te_w
    s = (qs[i] - qe_w) + tg
    g = np.where(s == 0, 0, go + ge * s)
    ok = (j < i) & (tg >= 0) & (tg <= mg) & (g < score[i])
    if not ok.any():
        return 0, 0
    return divmod(int(((cs[j] - g) * n + rank[j])[ok].max()), n)


def _gap(qg, tg):
    return 0 if qg + tg == 0 else GAP_OPEN + GAP_EXTEND * (qg + tg)


def window_candidates(qs, qe, mg=MAX_GAP) -> int:
    """The records in the max-gap windows of records in processing order:
    for each, those whose query end lies in [qs - mg, qs]."""
    qe = np.sort(qe)
    return int((np.searchsorted(qe, qs, side="right")
                - np.searchsorted(qe, qs - mg, side="left")).clip(0).sum())


def chain(recs: dict, stats: dict | None = None) -> dict:
    """paffy chain with its default costs: the records in its output order
    (descending score, stable), with cn and s1 set.  ``stats`` gets the
    count of candidates in the DP's windows ("candidates")."""
    n = len(recs["qstart"])
    qs, qe, ts, te = _chain_coords(recs)
    cid = np.full(n, -1, dtype=np.int64)
    cscore = np.full(n, -1, dtype=np.int64)
    out_order, next_id = [], 0
    for sel in (np.flatnonzero(recs["fwd"]), np.flatnonzero(~recs["fwd"])):
        idx = sel[np.lexsort((sel, qs[sel]))]
        m = len(idx)
        if m == 0:
            continue
        keys: dict = {}
        gid = np.array([keys.setdefault(k, len(keys)) for k in zip(
            recs["qname"][idx].tolist(), recs["tname"][idx].tolist())])
        cs = np.empty(m, dtype=np.int64)
        pred = np.full(m, -1, dtype=np.int64)
        for g in range(len(keys)):
            mem = np.flatnonzero(gid == g)
            r = idx[mem]
            if stats is not None:
                stats["candidates"] = stats.get("candidates", 0) + \
                    window_candidates(qs[r], qe[r])
            gcs, gpred = chain_dp(qs[r], qe[r], ts[r], te[r],
                                  recs["score"][r])
            cs[mem] = gcs
            pred[mem] = np.where(gpred >= 0, mem[np.maximum(gpred, 0)], -1)
        sqs, sqe, sts, ste, ssc = (a[idx].tolist() for a in
                                   (qs, qe, ts, te, recs["score"]))
        pl = pred.tolist()
        claimed = [False] * m
        for r in np.lexsort((-np.arange(m), -cs)).tolist():
            if claimed[r]:
                continue
            members = [r]
            claimed[r] = True
            p = pl[r]
            while p >= 0 and not claimed[p]:
                claimed[p] = True
                members.append(p)
                p = pl[p]
            total = ssc[members[0]]
            for a, b in zip(members[:-1], members[1:]):
                total += ssc[b] - _gap(sqs[a] - sqe[b], sts[a] - ste[b])
            rows = idx[members]
            cid[rows] = next_id
            cscore[rows] = total
            out_order.append(rows)
            next_id += 1
    order = np.concatenate(out_order)
    out = dict(recs)
    out.update(cn=cid, s1=cscore)
    out = take(out, order[np.argsort(-recs["score"][order], kind="stable")])
    return out


# -------------------------------------------------------------------- tile

def tile_levels(recs: dict, order) -> np.ndarray:
    """Levels of ``recs`` taken in ``order``: each record adds one to the
    count of every aligned query base it covers (the forward walk from
    qstart, on either strand), saturating at SATURATION; its level is the
    ((n+1)//2)-th smallest of its n new counts."""
    n = len(recs["qstart"])
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    rec, qoff, _ = _op_positions(recs)
    ops, lens = recs["ops"], recs["lens"]
    aligned = (ops != OP_I) & (ops != OP_D) & (lens > 0)
    rec, s = rec[aligned], recs["qstart"][rec[aligned]] + qoff[aligned]
    e = s + lens[aligned]
    # one interval per stretch of a record's touching aligned runs
    join = np.zeros(len(rec), dtype=bool)
    join[1:] = (rec[1:] == rec[:-1]) & (s[1:] == e[:-1])
    head = np.flatnonzero(~join)
    rec, s = rec[head], s[head]
    e = e[np.append(head[1:], len(join)) - 1]
    # positions of every query sequence end to end
    names, seq_of = np.unique(recs["qname"], return_inverse=True)
    qlen = np.zeros(len(names), dtype=np.int64)
    qlen[seq_of] = recs["qlen"]
    base = _csr(qlen)[:-1]
    s, e = s + base[seq_of[rec]], e + base[seq_of[rec]]
    # the elementary segments between all interval ends
    cuts = np.unique(np.concatenate([s, e]))
    a, b = np.searchsorted(cuts, s), np.searchsorted(cuts, e)
    eoff = _csr(b - a)
    seg = np.repeat(a - eoff[:-1], b - a) + np.arange(eoff[-1])
    prec = np.repeat(rec, b - a)
    seglen = cuts[seg + 1] - cuts[seg]
    # each (segment, record) pair's count: one plus the records before it
    by = np.lexsort((rank[prec], seg))
    seg, prec, seglen = seg[by], prec[by], seglen[by]
    first = np.ones(len(seg), dtype=bool)
    first[1:] = seg[1:] != seg[:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(len(seg)), 0))
    count = np.minimum(np.arange(len(seg)) - start + 1, SATURATION)
    # the median count of each record, by its bases
    by = np.lexsort((count, prec))
    prec, count, seglen = prec[by], count[by], seglen[by]
    cum = np.cumsum(seglen)
    total = np.bincount(prec, weights=seglen, minlength=n).astype(np.int64)
    rec_off = _csr(np.bincount(prec, minlength=n))
    before = np.where(rec_off[:-1] > 0, cum[np.maximum(rec_off[:-1] - 1, 0)],
                      0)
    need = before + (total + 1) // 2
    levels = np.full(n, EMPTY_TILE_LEVEL, dtype=np.int64)
    has = total > 0
    levels[has] = count[np.searchsorted(cum, need[has], side="left")]
    return levels


def tile(recs: dict) -> dict:
    """paffy tile: levels set, records in its best-first order."""
    n = len(recs["qstart"])
    order = np.lexsort((np.arange(n), -recs["score"], -recs["s1"]))
    out = dict(recs)
    out["tl"] = tile_levels(recs, order)
    return take(out, order)


# -------------------------------------------------------------------- trim

def _decide(ops, lens, seg, n_seg, thr, ident, mt, ftype):
    """Ops to trim from the front of each segment's walk (ops given in walk
    order, ``seg`` ascending): the prefix decision of impl/paf.c:811-904."""
    is_m = (ops == OP_M) | (ops == OP_EQ)
    m = np.where(is_m, lens, 0)
    mm = np.where(is_m, 0, lens)
    off = _csr(np.bincount(seg, minlength=n_seg))
    j = np.arange(len(seg)) - off[seg]
    cm, cmm = np.cumsum(m), np.cumsum(mm)
    b_m = np.where(off[:-1] > 0, cm[np.maximum(off[:-1] - 1, 0)], 0)
    b_mm = np.where(off[:-1] > 0, cmm[np.maximum(off[:-1] - 1, 0)], 0)
    pm, pmm = cm - b_m[seg], cmm - b_mm[seg]
    cols = pm + pmm
    with np.errstate(divide="ignore", invalid="ignore"):
        low = ((mt[seg] < 0) | (cols <= mt[seg])) & (
            pm.astype(ftype) / cols.astype(ftype) < thr[seg])
    hit = np.flatnonzero(low)
    last = np.ones(len(hit), dtype=bool)
    last[:-1] = seg[hit][1:] != seg[hit][:-1]
    trim_idx = np.full(n_seg, -1, dtype=np.int64)
    trim_idx[seg[hit[last]]] = j[hit[last]]
    out = np.zeros(n_seg, dtype=np.int64)
    todo = trim_idx >= 0
    if not todo.any():
        return out
    out[todo] = trim_idx[todo] + 1
    at = np.minimum(off[:-1] + np.maximum(trim_idx, 0), len(pm) - 1)
    pm_ti, pmm_ti = pm[at], pmm[at]
    # the re-included suffix: the first j <= trim_idx whose remainder holds
    # the record's identity
    sm = pm_ti[seg] - (pm - m)
    smm = pmm_ti[seg] - (pmm - mm)
    with np.errstate(divide="ignore", invalid="ignore"):
        good = (todo[seg] & (j <= trim_idx[seg])
                & (sm.astype(ftype) / (sm + smm).astype(ftype)
                   >= ident[seg]))
    hit = np.flatnonzero(good)
    first = np.ones(len(hit), dtype=bool)
    first[1:] = seg[hit][1:] != seg[hit][:-1]
    out[seg[hit[first]]] = j[hit[first]]
    return out


def trim(recs: dict, precision=np.float32) -> dict:
    """paf_trim_unreliable_tails(0.05, 1.0) on every record: the identity
    arithmetic in ``precision`` (paffy's float32; a lower one for the
    control)."""
    ft = precision
    off, ops, lens, fwd = recs["off"], recs["ops"], recs["lens"], recs["fwd"]
    n = len(off) - 1
    rec = _seg_ids(off)
    is_m = (ops == OP_M) | (ops == OP_EQ)
    tot_m = np.bincount(rec, weights=np.where(is_m, lens, 0),
                        minlength=n).astype(np.int64)
    tot_mm = np.bincount(rec, weights=np.where(is_m, 0, lens),
                         minlength=n).astype(np.int64)
    cols = tot_m + tot_mm
    with np.errstate(divide="ignore", invalid="ignore"):
        ident = tot_m.astype(ft) / cols.astype(ft)
    i64 = ident.astype(np.float64)
    thr = (i64 - i64 * np.float64(np.float32(TRIM_IDENTITY))).astype(ft)
    with np.errstate(invalid="ignore"):
        mt = np.trunc(cols.astype(np.float32) * np.float32(TRIM_FRACTION))
    mt = mt.astype(np.int64)
    tc1 = _decide(ops, lens, rec, n, thr, ident, mt, ft)
    a = off[:-1] + tc1
    # pass 2 on the inverted remainder: forward on '+', backward on '-'
    rem = off[1:] - a
    pos = np.repeat(a - _csr(rem)[:-1], rem) + np.arange(int(rem.sum()))
    seg2 = np.repeat(np.arange(n), rem)
    back = ~fwd[seg2]
    pos = np.where(back, off[1:][seg2] - 1 - (pos - a[seg2]), pos)
    tc2 = _decide(ops[pos], lens[pos], seg2, n, thr, ident, mt, ft)
    keep_a = np.where(fwd, a + tc2, a)
    keep_b = np.where(fwd, off[1:], off[1:] - tc2)
    d2a = np.where(fwd, a, off[1:] - tc2)
    d2b = np.where(fwd, a + tc2, off[1:])
    qc = np.cumsum(np.append(0, np.where(ops != OP_D, lens, 0)))
    tcn = np.cumsum(np.append(0, np.where(ops != OP_I, lens, 0)))
    dq1, dt1 = qc[a] - qc[off[:-1]], tcn[a] - tcn[off[:-1]]
    dq2, dt2 = qc[d2b] - qc[d2a], tcn[d2b] - tcn[d2a]
    out = dict(recs)
    out.update(
        qstart=recs["qstart"] + np.where(fwd, dq1, 0) + dq2,
        qend=recs["qend"] - np.where(fwd, 0, dq1),
        tstart=recs["tstart"] + dt1 + np.where(fwd, dt2, 0),
        tend=recs["tend"] - np.where(fwd, 0, dt2))
    new_off = _csr(keep_b - keep_a)
    pos = np.repeat(keep_a - new_off[:-1], keep_b - keep_a) + np.arange(
        new_off[-1])
    out.update(ops=ops[pos], lens=lens[pos], off=new_off)
    return out


# --------------------------------------------------------------- serialize

def _digits(v: np.ndarray):
    """(bytes, offsets) of the decimal text of non-negative ``v``."""
    v = np.asarray(v, dtype=np.int64)
    nd = np.ones(len(v), dtype=np.int64)
    p = 10
    while p <= max(int(v.max(initial=0)), 1):
        nd += v >= p
        p *= 10
    off = _csr(nd)
    buf = np.empty(off[-1], dtype=np.uint8)
    x = v.copy()
    for d in range(int(nd.max(initial=1))):
        live = nd > d
        buf[off[1:][live] - 1 - d] = (x[live] % 10 + 48).astype(np.uint8)
        x //= 10
    return buf, off


def serialize(recs: dict) -> bytes:
    """The PAF lines of ``recs``, each with its newline."""
    n = len(recs["qstart"])
    tl = recs.get("tl", np.full(n, -1))
    cn = recs.get("cn", np.full(n, -1))
    # the cigar text: each op's length then its letter
    dig, doff = _digits(recs["lens"])
    tok_off = _csr(np.diff(doff) + 1)
    cig = np.empty(tok_off[-1], dtype=np.uint8)
    k = np.repeat(np.arange(len(recs["lens"])), np.diff(doff))
    cig[np.arange(len(dig)) + (tok_off[:-1] - doff[:-1])[k]] = dig
    cig[tok_off[1:] - 1] = OP_CHARS[recs["ops"]]
    cig_off = tok_off[recs["off"]]
    cig = cig.tobytes()
    cols = [recs[k].tolist() for k in (
        "qname", "qlen", "qstart", "qend", "tname", "tlen", "tstart",
        "tend", "nmatch", "nbases", "mapq", "score", "s1")]
    fwd, tl, cn = recs["fwd"].tolist(), tl.tolist(), cn.tolist()
    parts = []
    for r, (qn, ql, qs, qe, tn, tln, ts, te, nm, nb, mq, sc, s1) in \
            enumerate(zip(*cols)):
        lv, c = tl[r], cn[r]
        line = (f"{qn}\t{ql}\t{qs}\t{qe}\t{'+' if fwd[r] else '-'}"
                f"\t{tn}\t{tln}\t{ts}\t{te}\t{nm}\t{nb}\t{mq}")
        if lv != -1:
            line += "\ttp:A:" + ("S" if lv > 1 else "P")
        if sc != INT_MAX:
            line += f"\tAS:i:{sc}"
        if lv != -1:
            line += f"\ttl:i:{lv}"
        if c != -1:
            line += f"\tcn:i:{c}"
        if s1 != -1:
            line += f"\ts1:i:{s1}"
        parts.append(line.encode() + b"\tcg:Z:")
        parts.append(cig[cig_off[r]: cig_off[r + 1]])
        parts.append(b"\n")
    return b"".join(parts)


# -------------------------------------------------------------------- jobs

def _counts(recs: dict, enc: dict) -> dict:
    """What the input asks of the kernels: records, M columns and M runs
    (K4's reads), =/X runs (K4's writes, K5's intervals)."""
    m = (recs["ops"] == OP_M)
    x = (enc["ops"] == OP_EQ) | (enc["ops"] == OP_X)
    return {"records": int(len(recs["qstart"])),
            "columns": int(recs["lens"][m].sum()),
            "m_runs": int(np.count_nonzero(m & (recs["lens"] > 0))),
            "eqx_runs": int(np.count_nonzero(x))}


def add_mismatches_jobs(recs: dict, seqs: dict, keys, control=False):
    """({"whole": bytes}, {"whole": [work of its one encode launch]}) of
    ``paffy add_mismatches`` on the records; ``control`` compares the bytes
    as they are, without upper-casing (paffy folds case)."""
    ident = np.arange(256, dtype=np.uint8)
    enc = (encode(recs, seqs, ident, COMP) if control
           else encode(recs, seqs))
    return {"whole": serialize(enc)}, {"whole": [_counts(recs, enc)]}


def pipeline_jobs(recs: dict, seqs: dict, keys, control=False):
    """The pipeline's bytes and work per job key: ``whole`` for all the
    records (the contig groups one after another, in first-seen order), a
    query contig's name for its records alone; one entry of work per
    contig group (one launch each of K4's count and fill, K6 and K5).
    ``control`` computes the trim's identities in float16."""
    names = recs["qname"]
    uniq, first, inv = np.unique(names, return_index=True,
                                 return_inverse=True)
    out, work = {}, {}
    for g in np.argsort(first, kind="stable").tolist():
        t = take(recs, np.flatnonzero(inv == g))
        enc = encode(t, seqs)
        stats = _counts(t, enc)
        t = tile(chain(enc, stats))
        out[str(uniq[g])] = serialize(
            trim(t, np.float16 if control else np.float32))
        work[str(uniq[g])] = [stats]
    groups = list(out)
    out["whole"] = b"".join(out[k] for k in groups)
    work["whole"] = [w for k in groups for w in work[k]]
    return ({k: out[k] for k in keys}, {k: work[k] for k in keys})
