"""Aligned query intervals for coverage (counterpart of
paffy_tpu/ops/coverage.py: ``match_intervals`` :32, ``SATURATION``,
``EMPTY_TILE_LEVEL``; the reference's SequenceCountArray walk,
impl/paf.c:669-709): one interval per M/=/X op, in query coordinates, by
the forward walk from qstart that every strand takes."""

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
