"""Per-record alignment stats over the CSR cigar store (counterpart of
paffy_tpu/ops/transforms.py:48-93, ``stats_calc_with_m``; the reference's
paf_stats_calc, impl/paf.c:236-260)."""

from __future__ import annotations

import numpy as np

from paffy_tpu_torch import native
from paffy_tpu_torch.core.model import PafTable

STAT_KEYS = ("matches", "mismatches", "query_inserts", "query_deletes",
             "query_insert_bases", "query_delete_bases")


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
