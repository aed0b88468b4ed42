"""Identity-based trimming of unreliable alignment tails (counterpart of
paffy_tpu/ops/tailtrim.py :144-210, ``trim_unreliable_tails``; the
reference's paf_trim_unreliable_tails and its helpers, impl/paf.c:811-953).

For each record: its identity i counts indel bases as mismatches; the
longest prefix whose identity is below i - i * score_fraction (at most
max_fraction of the record's columns) is cut back by re-including its
longest suffix of identity >= i, and the whole ops before that point are
dropped; then the same on the record inverted, for the suffix.  The float
arithmetic is the reference's mixed float32/double, so the decisions are
bit-identical.

Both passes run in one threaded native sweep: ``native.trim_tails_raw``
over a raw-cigar table (the kept cigar is a byte range of the cg text),
``native.trim_tails_apply`` plus ``native.copy_op_ranges`` over a parsed
one.  paffy_tpu's numpy oracle is not copied.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from paffy_tpu_torch import native
from paffy_tpu_torch.core.model import PafTable


def _trimmed_coords(t: PafTable, dq1, dt1, dq2, dt2) -> dict:
    # pass 1 trims the cigar's front: query from qstart ('+') or qend
    # ('-'), target from tstart.  Pass 2, in the inverted frame, takes
    # query from qstart on both strands (for '+' this trims the front
    # again, as the reference does) and target from tstart ('+') or tend
    # ('-').
    return dict(qstart=t.qstart + np.where(t.strand, dq1, 0) + dq2,
                qend=t.qend - np.where(t.strand, 0, dq1),
                tstart=t.tstart + dt1 + np.where(t.strand, dt2, 0),
                tend=t.tend - np.where(t.strand, 0, dt2))


def trim_unreliable_tails(t: PafTable, score_fraction: float,
                          max_fraction_to_trim: float) -> PafTable:
    """paf_trim_unreliable_tails over a whole batch (impl/paf.c:906-953);
    a batch in which nothing is trimmed comes back as it is."""
    if len(t) == 0 or (len(t.ops) == 0 and t.raw_cg is None):
        return t
    if t.raw_cg is not None:
        cg_a, cg_n, *deltas = native.trim_tails_raw(t, score_fraction,
                                                    max_fraction_to_trim)
        raw_buf, cg_start, cg_len = t.raw_cg
        if np.array_equal(cg_a, cg_start) and np.array_equal(cg_n, cg_len):
            return t
        return replace(t, **_trimmed_coords(t, *deltas),
                       raw_cg=(raw_buf, cg_a, cg_n))
    keep_a, keep_b, *deltas = native.trim_tails_apply(
        t.off, t.ops, t.lens, t.strand, score_fraction, max_fraction_to_trim)
    if (np.array_equal(keep_a, t.off[:-1])
            and np.array_equal(keep_b, t.off[1:])):
        return t
    new_off = np.zeros(len(t) + 1, dtype=np.int64)
    np.cumsum(keep_b - keep_a, out=new_off[1:])
    new_ops, new_lens = native.copy_op_ranges(keep_a, keep_b, new_off, t.ops,
                                              t.lens)
    return replace(t, **_trimmed_coords(t, *deltas), ops=new_ops,
                   lens=new_lens, off=new_off)
