"""The plain reference of ``paffy view -s``: each record's stat line and the
aggregate line, in NumPy, from the records and sequences the generator
made (perfbench/synth.py), to the bytes paffy writes.

paffy view re-encodes each record's M ops as =/X runs before it counts
(impl/paf_view.c:167-178), so a record's matches are its M columns whose
upper-cased bytes agree (``reference.encode``) plus its '=' bases, and
its mismatches the rest of its M columns plus its 'X' bases.  Inserts
and deletes count as events and as bases (paf_stats_calc,
impl/paf.c:236-260).  The stat line is paf_pretty_print's
(impl/paf.c:269-281): the identities are C floats, matches over
matches plus mismatches, with the gapped bases too for the second,
printed by ``%f``; the aggregate line is impl/paf_view.c:186-197's.

Imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np

import reference as ref


def _f(x) -> str:
    """C's ``%f`` of a float: six decimals, and NaN with its sign, as glibc
    prints the -nan that x86 gives for 0.0f / 0.0f."""
    v = float(x)
    if v != v:
        return "-nan" if np.signbit(x) else "nan"
    return f"{v:.6f}"


def _ident(num, den):
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.float32(num) / np.float32(den)


def record_stats(recs: dict, seqs: dict, control: bool = False):
    """(per record: matches, mismatches, query_inserts, query_deletes (I and
    D ops), query_insert_bases, query_delete_bases, after the =/X
    re-encode; the encoded records); ``control`` compares the bytes
    without folding case."""
    if control:
        enc = ref.encode(recs, seqs, np.arange(256, dtype=np.uint8),
                         ref.COMP)
    else:
        enc = ref.encode(recs, seqs)
    n = len(recs["qstart"])
    rec = ref._seg_ids(enc["off"])
    ops, lens = enc["ops"], enc["lens"]

    def per(sel, weights):
        return np.bincount(rec[sel], weights=weights[sel],
                           minlength=n).astype(np.int64)
    ones = np.ones(len(ops), dtype=np.int64)
    return {"matches": per((ops == ref.OP_M) | (ops == ref.OP_EQ), lens),
            "mismatches": per(ops == ref.OP_X, lens),
            "query_inserts": per(ops == ref.OP_I, ones),
            "query_deletes": per(ops == ref.OP_D, ones),
            "query_insert_bases": per(ops == ref.OP_I, lens),
            "query_delete_bases": per(ops == ref.OP_D, lens)}, enc


def view_stats(recs: dict, seqs: dict, control: bool = False):
    """(the bytes of ``paffy view -s``, the encoded records)."""
    st, enc = record_stats(recs, seqs, control)
    m, x = st["matches"], st["mismatches"]
    qi, qd = st["query_inserts"], st["query_deletes"]
    qib, qdb = st["query_insert_bases"], st["query_delete_bases"]
    ident = _ident(m, m + x)
    ident_g = _ident(m, m + x + qib + qdb)
    cols = [recs[k].tolist() for k in (
        "qname", "qstart", "qend", "tname", "tstart", "tend", "score")]
    fwd = recs["fwd"].tolist()
    lines = []
    for r, (qn, qs, qe, tn, ts, te, sc) in enumerate(zip(*cols)):
        lines.append(
            f"Query:{qn}\tQ-start:{qs}\tQ-length:{qe - qs}\tTarget:{tn}"
            f"\tT-start:{ts}\tT-length:{te - ts}\tSame-strand:{int(fwd[r])}"
            f"\tScore:{sc}\tIdentity:{_f(ident[r])}"
            f"\tIdentity-with-gaps{_f(ident_g[r])}"
            f"\tAligned-bases:{m[r] + x[r]}\tQuery-inserts:{qi[r]}"
            f"\tQuery-deletes:{qd[r]}\n")
    tm, tx, tqi, tqd, tqib, tqdb = (int(a.sum()) for a in (m, x, qi, qd,
                                                           qib, qdb))
    lines.append(
        f"Total-alignments:{len(fwd)}\tAvg-Identity:{_f(_ident(tm, tm + tx))}"
        f"\tAvg-Identity-with-gaps:"
        f"{_f(_ident(tm, tm + tx + tqib + tqdb))}"
        f"\tAligned-bases:{tm + tx}"
        f"\tAligned-bases-with-gaps:{tm + tx + tqib + tqdb}"
        f"\tQuery-inserts:{tqi}\tQuery-deletes:{tqd}\n")
    return "".join(lines).encode(), enc


def view_stats_jobs(recs: dict, seqs: dict, keys, control=False):
    """({"whole": bytes}, {"whole": [work of its one K1 launch]}) of ``paffy
    view -s`` on the records: the work is the input's records, M columns
    and M runs (K1's reads and writes).  ``control`` compares the bytes as
    they are, without upper-casing (paffy folds case)."""
    out, enc = view_stats(recs, seqs, control)
    work = {k: v for k, v in ref._counts(recs, enc).items()
            if k in ("records", "columns", "m_runs")}
    return {"whole": out}, {"whole": [work]}
