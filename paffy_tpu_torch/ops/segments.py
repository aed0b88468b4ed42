"""The M-run column batch and the sequence pool's layout constants (host
side; counterpart of paffy_tpu/ops/segments.py:24-175).

``build_m_column_batch`` turns a PafTable's cigar store into per-M-op
arrays: run length, record, and the pool positions of each run's first
query and target column, in one native pass.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from paffy_tpu_torch import native
from paffy_tpu_torch.core.model import MATCH, PafTable

# The guarded pool's length is a multiple of POOL_W, and every pool has
# POOL_GUARD zero bytes at both ends (ops/mismatch.py).  K1 reads ext in
# aligned 16-byte words, which needs 2 * pool length to be a multiple of 16.
POOL_W = 512
POOL_GUARD = 4096


def bucket_size(n: int, minimum: int = 256) -> int:
    """Next power of two >= n (and >= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class MColumnBatch:
    """All alignment columns of the M runs of a batch.

    Per M-op arrays (padded to a power of two; ``[:n_mops]`` are the runs):
      lens, rec      — run length, owning record index
      qpos0, tpos0   — pool position of the run's first query / target
                       column
      rev            — True iff the query walks backward (opposite strand)
      col_off        — exclusive cumsum of lens (padded length + 1)
    ``rec_col_off`` maps record -> first column index ([n_records+1]).
    ``n_cols`` is the true column count, ``n_cols_pad`` its bucket.
    """

    lens: np.ndarray
    rec: np.ndarray
    qpos0: np.ndarray
    tpos0: np.ndarray
    rev: np.ndarray
    col_off: np.ndarray
    rec_col_off: np.ndarray
    flat_idx: np.ndarray  # index of each M op in the batch's flat op arrays
    n_mops: int
    n_cols: int
    n_cols_pad: int


def build_m_column_batch(t: PafTable, qpool_off: np.ndarray,
                         tpool_off: np.ndarray,
                         col_bucket: int | None = None) -> MColumnBatch:
    """The M-run column batch of ``t``; ``qpool_off``/``tpool_off`` are the
    per-record pool offsets of the record's query / target sequence.  One C
    pass over the cigar store fills the padded arrays.  First-column
    positions follow paf_encode_mismatches (impl/paf.c:750-757): the query
    walks forward from qstart for '+', backward from qend-1 for '-'; the
    target always forward from tstart."""
    n_mops = int(np.count_nonzero(t.ops == MATCH))
    mop_pad = bucket_size(max(n_mops, 1))
    n = len(t)
    outs = dict(
        mlens=np.zeros(mop_pad, dtype=np.int64),
        recs=np.full(mop_pad, max(n - 1, 0), dtype=np.int64),
        qpos0=np.zeros(mop_pad, dtype=np.int64),
        tpos0=np.zeros(mop_pad, dtype=np.int64),
        rev=np.zeros(mop_pad, dtype=np.uint8),
        col_off=np.zeros(mop_pad + 1, dtype=np.int64),
        rec_col_off=np.zeros(n + 1, dtype=np.int64),
        flat_idx=np.zeros(max(n_mops, 1), dtype=np.int64),
    )
    n_cols = native.build_mop_batch(
        n, t.ops, t.lens, t.off, t.strand, t.qstart, t.qend, t.tstart,
        qpool_off, tpool_off, n_mops, outs)
    outs["col_off"][n_mops + 1:] = n_cols
    return MColumnBatch(
        lens=outs["mlens"], rec=outs["recs"], qpos0=outs["qpos0"],
        tpos0=outs["tpos0"], rev=outs["rev"].view(bool),
        col_off=outs["col_off"], rec_col_off=outs["rec_col_off"],
        flat_idx=outs["flat_idx"][:n_mops],
        n_mops=n_mops, n_cols=n_cols,
        n_cols_pad=col_bucket or bucket_size(max(n_cols, 1)))
