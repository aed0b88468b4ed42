"""Host segment reductions over CSR offset tables (counterpart of
paffy_tpu/core/segsum.py): per-record sums of flat per-op values, and the
record of each flat op."""

from __future__ import annotations

import numpy as np


def segment_sums_by_offsets(values: np.ndarray, off: np.ndarray) -> np.ndarray:
    """Per-record sums of ``values`` partitioned by CSR ``off`` (len N+1)."""
    n = len(off) - 1
    if len(values) == 0:
        return np.zeros(n, dtype=values.dtype if values.dtype != np.bool_
                        else np.int64)
    c = np.concatenate([[0], np.cumsum(values.astype(np.int64))])
    return c[off[1:]] - c[off[:-1]]


def segment_ids_from_offsets(off: np.ndarray,
                             total: int | None = None) -> np.ndarray:
    """Flat op index -> record index (the inverse of the CSR offsets)."""
    if total is None:
        total = int(off[-1])
    ids = np.zeros(total, dtype=np.int64)
    # mark the starts of records 1..N-1, then cumsum
    starts = off[1:-1]
    np.add.at(ids, starts[starts < total], 1)
    return np.cumsum(ids)
