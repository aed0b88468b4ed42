"""Coverage of query sequences by aligned runs (counterpart of
paffy_tpu/ops/coverage.py: ``match_intervals`` :32, ``CoverageMap`` :63,
``run_length_rows`` :145, ``SATURATION``, ``EMPTY_TILE_LEVEL``; the
reference's SequenceCountArray walk, impl/paf.c:669-709).

One interval per M/=/X op, in query coordinates, by the forward walk from
qstart that every strand takes.  Coverage is a difference array per
sequence (+1 at each interval's start, -1 at its end) summed once: counts
only grow, so the sum clipped at SATURATION is the reference's per-base
saturating count.
"""

from __future__ import annotations

import numpy as np

from paffy_tpu_torch import native
from paffy_tpu_torch.core.model import PafTable

SATURATION = 32766        # INT16_MAX - 1: per-base counts stop here (impl/paf.c:700)
EMPTY_TILE_LEVEL = 32767  # INT16_MAX: the level of a record with no aligned base (impl/paf_tile.c:64)


def match_intervals(t: PafTable) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rec, start, end) int64 of every aligned run's query interval, in
    op order, in one native pass."""
    if len(t.ops) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    return native.match_intervals(t.off, t.ops, t.lens, t.qstart)


class CoverageMap:
    """Per-sequence coverage counts, the sequences in first-seen order."""

    def __init__(self):
        self.names: list[str] = []
        self._idx: dict[str, int] = {}
        self.lengths: list[int] = []
        self._diffs: list[np.ndarray] = []

    def _get(self, name: str, length: int) -> int:
        i = self._idx.get(name)
        if i is None:
            i = len(self.names)
            self._idx[name] = i
            self.names.append(name)
            self.lengths.append(int(length))
            self._diffs.append(np.zeros(int(length) + 1, dtype=np.int32))
        elif self.lengths[i] != int(length):
            raise ValueError(
                f"sequence {name!r} seen with inconsistent lengths "
                f"{self.lengths[i]} vs {length}")
        return i

    def register_batch(self, names, lengths) -> np.ndarray:
        """Register the unseen names of parallel name/length arrays in
        first-seen order; the index of each entry.  Every occurrence of a
        name must carry its registered length."""
        names = np.asarray(names, dtype=object)
        lengths = np.asarray(lengths, dtype=np.int64)
        if len(names) == 0:
            return np.empty(0, dtype=np.int64)
        uniq, first, inv = np.unique(names, return_index=True,
                                     return_inverse=True)
        for j in np.argsort(first, kind="stable").tolist():
            self._get(uniq[j], int(lengths[first[j]]))
        base = np.fromiter((self._idx[nm] for nm in uniq),
                           dtype=np.int64, count=len(uniq))
        idx = base[inv]
        reg = np.asarray(self.lengths, dtype=np.int64)[idx]
        off = np.flatnonzero(reg != lengths)
        if len(off):
            i = int(off[0])
            raise ValueError(
                f"sequence {names[i]!r} seen with inconsistent lengths "
                f"{reg[i]} vs {lengths[i]}")
        return idx

    def add(self, t: PafTable) -> None:
        """Add a batch's aligned runs to its query sequences' coverage (a
        record without runs still registers its sequence)."""
        rec, start, end = match_intervals(t)
        seq_of_rec = self.register_batch(t.qname, t.qlen)
        if len(rec) == 0:
            return
        sid = seq_of_rec[rec]
        for i in np.unique(sid):
            m = sid == i
            native.coverage_add(self._diffs[int(i)], start[m], end[m])

    def counts(self, name: str) -> np.ndarray:
        """The saturated uint16 counts of one sequence."""
        return native.coverage_counts(self._diffs[self._idx[name]][:-1],
                                      SATURATION)


def run_length_rows(counts: np.ndarray, binary: bool
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starts, ends, values) of the maximal runs of equal counts (write_bed,
    impl/paf_to_bed.c:33-55); ``binary`` splits on count > 0 instead."""
    if len(counts) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    return native.rle_u16(counts, binary)
