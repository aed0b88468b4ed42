"""Columnar (SoA) data model for PAF records (counterpart of
paffy_tpu/core/model.py: ``PafTable`` and the cigar op codes).

A batch of PAF records is held as parallel numpy arrays plus one CSR cigar
store: the op codes and run lengths of all records in two flat arrays,
addressed by a per-record offset table.  Field semantics are the
reference's (inc/paf.h:12-58): score defaults to 0, tile_level / chain_id /
chain_score to -1, and op codes are the reference enum values.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from paffy_tpu_torch import native

# Cigar op codes, numerically the reference enum (inc/paf.h:52-58)
MATCH = 0            # 'M'
QUERY_INSERT = 1     # 'I'  (substring in the query, not the target)
QUERY_DELETE = 2     # 'D'  (substring in the target, not the query)
SEQ_MATCH = 3        # '='
SEQ_MISMATCH = 4     # 'X'

OP_TO_CHAR = "MID=X"

INT_MAX = 2147483647  # C INT_MAX: the reference's "no score" sentinel (impl/paf.c:349)


@dataclass
class PafTable:
    """A batch of PAF records in columnar form.

    All arrays have length N (number of records).  The cigar store is CSR:
    record i's ops are ``ops[off[i]:off[i+1]]`` / ``lens[off[i]:off[i+1]]``.
    ``has_cigar[i]`` distinguishes "no cg tag" from an empty cigar.
    """

    qname: np.ndarray   # object (str)
    qlen: np.ndarray    # int64
    qstart: np.ndarray  # int64
    qend: np.ndarray    # int64
    strand: np.ndarray  # bool — True iff '+' (same_strand)
    tname: np.ndarray   # object (str)
    tlen: np.ndarray    # int64
    tstart: np.ndarray  # int64
    tend: np.ndarray    # int64
    num_matches: np.ndarray  # int64
    num_bases: np.ndarray    # int64
    mapq: np.ndarray         # int64
    score: np.ndarray        # int64, default 0 (AS tag)
    tile_level: np.ndarray   # int64, default -1 (tl tag)
    chain_id: np.ndarray     # int64, default -1 (cn tag)
    chain_score: np.ndarray  # int64, default -1 (s1 tag)
    type: np.ndarray         # uint8, 0 = unset, else ord('P'/'S'/'I') (tp tag)
    has_cigar: np.ndarray    # bool
    ops: np.ndarray          # uint8  [T] — op codes
    lens: np.ndarray         # int64  [T] — run lengths
    off: np.ndarray          # int64  [N+1] — CSR offsets into ops/lens
    # raw-cigar mode (the reference's read_pafs(parse_cigar=0)):
    # (input_buffer: bytes, cg_start[N], cg_len[N]) byte ranges of each
    # unparsed cg tag; ops/lens are empty and off is all-zero
    raw_cg: tuple | None = None

    def __len__(self) -> int:
        return len(self.qlen)

    def take(self, idx) -> "PafTable":
        """Row-subset (and/or reorder) by integer indices or boolean mask."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            if idx.all():
                return self
            idx = np.nonzero(idx)[0]
        counts = (self.off[1:] - self.off[:-1])[idx]
        new_off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(counts, out=new_off[1:])
        starts = self.off[:-1][idx]
        new_ops, new_lens = native.copy_op_ranges(starts, starts + counts,
                                                  new_off, self.ops, self.lens)
        return PafTable(
            qname=self.qname[idx], qlen=self.qlen[idx], qstart=self.qstart[idx],
            qend=self.qend[idx], strand=self.strand[idx], tname=self.tname[idx],
            tlen=self.tlen[idx], tstart=self.tstart[idx], tend=self.tend[idx],
            num_matches=self.num_matches[idx], num_bases=self.num_bases[idx],
            mapq=self.mapq[idx], score=self.score[idx],
            tile_level=self.tile_level[idx], chain_id=self.chain_id[idx],
            chain_score=self.chain_score[idx], type=self.type[idx],
            has_cigar=self.has_cigar[idx],
            ops=new_ops, lens=new_lens, off=new_off,
            raw_cg=(None if self.raw_cg is None else
                    (self.raw_cg[0], self.raw_cg[1][idx],
                     self.raw_cg[2][idx])))

    def with_cigars(self, ops: np.ndarray, lens: np.ndarray,
                    off: np.ndarray) -> "PafTable":
        """The same records with another CSR cigar store (no copy of arrays
        that already have the model's types)."""
        return replace(self, ops=ops.astype(np.uint8, copy=False),
                       lens=lens.astype(np.int64, copy=False),
                       off=off.astype(np.int64, copy=False))
