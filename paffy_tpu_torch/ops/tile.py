"""Greedy tile levels (counterpart of paffy_tpu/ops/tile.py:
``assign_tile_levels`` :138, ``assign_tile_levels_sharded`` :193,
``tile_sort_order`` :339; the reference's paffy tile,
impl/paf_tile.c:36-93,156-178).

Records are taken best-first; each adds one to the uint16 count of every
aligned query base it covers (saturating at SATURATION), and its level is
the median of its new counts: the ((n+1)//2)-th smallest over its n
aligned bases, EMPTY_TILE_LEVEL when it has none.

The sweep runs on the device, always (K5, ops/tile_device.py).  Unlike
paffy_tpu, the port packs no coverage segments (``_sequence_offsets``),
builds no padded [N, K] interval tensor and has no TILE_K_CAP or
TILE_DEVICE_WORK_CAP host route: the kernel reads the intervals in CSR
form (``run_off``, ``istart``, ``iend`` from ``match_intervals``) and one
count arena with each distinct query sequence's counts end to end,
exactly the arguments of the C sweep (native.tile_sweep).  On a mesh
(``assign_tile_levels_sharded``), the distinct query sequences are cut
into blocks over the mesh's data rows, each with its own arena.
"""

from __future__ import annotations

import numpy as np
import torch

from paffy_tpu_torch import devconf, phases
from paffy_tpu_torch.core.model import PafTable
from paffy_tpu_torch.ops.coverage import (EMPTY_TILE_LEVEL, SATURATION,
                                          match_intervals)
from paffy_tpu_torch.ops.tile_device import tile_sweep


def tile_sort_order(t: PafTable) -> np.ndarray:
    """Best-first processing order: descending (chain_score, score), ties
    in input order (paf_cmp_by_descending_score, impl/paf_tile.c:28-34)."""
    return np.lexsort((np.arange(len(t)), -t.score, -t.chain_score))


def sweep_arguments(t: PafTable):
    """(arena_off, run_off, istart, iend, arena_len): the C sweep's
    arguments for ``t``, the arena laid out by first-seen query name.
    Raises ValueError when one query name comes with two lengths."""
    n = len(t)
    names, first, inv = np.unique(t.qname, return_index=True,
                                  return_inverse=True)
    qlen = t.qlen[first]
    bad = np.flatnonzero(t.qlen != qlen[inv])
    if len(bad):
        raise ValueError(f"query {t.qname[bad[0]]!r} has inconsistent "
                         f"lengths")
    seen = np.argsort(first, kind="stable")      # names in first-seen order
    off = np.zeros(len(names), dtype=np.int64)
    off[seen] = np.cumsum(qlen[seen]) - qlen[seen]
    rec, istart, iend = match_intervals(t)
    run_off = np.searchsorted(rec, np.arange(n + 1)).astype(np.int64)
    return off[inv], run_off, istart, iend, int(qlen.sum())


def assign_tile_levels(t: PafTable, order: np.ndarray,
                       cap: int = SATURATION) -> np.ndarray:
    """int64 tile levels of the records of ``t`` (indexed as ``t``), taken
    in ``order``, by K5 on the device; ``cap`` is the saturation count."""
    return assign_tile_levels_sharded(t, order, None, cap)


def assign_tile_levels_sharded(t: PafTable, order: np.ndarray, mesh=None,
                               cap: int = SATURATION) -> np.ndarray:
    """``assign_tile_levels`` over ``mesh``'s data rows: the query
    sequences, in first-seen order, are cut into ``data`` contiguous blocks
    of ceil(S / data) (paffy_tpu's contiguous blocks of coverage segments
    play this part), and each block's records, in ``order``, run in one K5
    launch on its row's first device over an arena of its own sequences.
    Records on different sequences commute, so the levels do not depend on
    the mesh.  Without one, all sequences are one block on
    ``devconf.device()``."""
    n = len(t)
    if n == 0:
        return np.full(0, EMPTY_TILE_LEVEL, dtype=np.int64)
    rows = ([devconf.device()] if mesh is None
            else [row[0] for row in mesh.devices])
    with phases.timed("intervals"):
        arena_off, run_off, istart, iend, total = sweep_arguments(t)
        # the sequences by arena offset, which ascends in first-seen order
        # (a sequence of no bases shares the next one's and goes with it)
        seq_off, seq_of = np.unique(arena_off, return_inverse=True)
        size = -(-len(seq_off) // len(rows))
        bounds = np.append(seq_off[::size], total)
        block = seq_of // size
        order = np.asarray(order, dtype=np.int64)
    levels = np.full(n, EMPTY_TILE_LEVEL, dtype=np.int64)
    shared: dict = {}                  # the CSR arguments on each device
    launched = []
    for b, dev in enumerate(rows[: len(bounds) - 1]):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        sub = order[block[order] == b]
        with phases.timed("upload", dev):
            if dev not in shared:
                shared[dev] = [devconf.upload(a, dev)
                               for a in (run_off, istart, iend)]
            # the block's arena starts at its first sequence; records of
            # other blocks are not in its order, so their offsets are unread
            args = [devconf.upload(a, dev) for a in (sub, arena_off - lo)]
            arena = torch.zeros(max(hi - lo, 1), dtype=torch.int16,
                                device=dev)
        with phases.timed("K5"):
            launched.append((sub, tile_sweep(args[0], args[1], *shared[dev],
                                             arena, cap)))
    with phases.timed("K5"):          # ends with the readbacks
        for sub, lv in launched:
            levels[sub] = devconf.to_host_i64(lv)[sub]
    return levels
