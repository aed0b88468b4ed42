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
form (``run_off``, ``istart``, ``iend`` from ``native.tile_intervals``:
one interval per maximal stretch of a record's touching aligned runs,
which covers the bases its runs cover, so the levels are those of the
per-run intervals) and each record's offset into one position space with
each distinct query sequence's positions end to end, the arguments of the
C sweep (native.tile_sweep) but its arena: the kernel keeps its counts on
the chip.  However deep the records stack, the sweep stays on the device:
it runs in batches of records whose histogram rows fit
tile_device.HIST_BUDGET, one launch each.  On a mesh
(``assign_tile_levels_sharded``), the distinct query sequences are cut
into blocks over the mesh's data rows, each with its own position space.
"""

from __future__ import annotations

import numpy as np

from paffy_tpu_torch import devconf, native, phases
from paffy_tpu_torch.core.model import PafTable
from paffy_tpu_torch.ops.coverage import EMPTY_TILE_LEVEL, SATURATION
from paffy_tpu_torch.ops.tile_device import tile_sweep


def tile_sort_order(t: PafTable) -> np.ndarray:
    """Best-first processing order: descending (chain_score, score), ties
    in input order (paf_cmp_by_descending_score, impl/paf_tile.c:28-34)."""
    return np.lexsort((np.arange(len(t)), -t.score, -t.chain_score))


def sweep_arguments(t: PafTable):
    """(arena_off, run_off, istart, iend, arena_len): the C sweep's
    arguments for ``t``, the arena laid out by first-seen query name, one
    interval per stretch of touching aligned runs; counts the aligned runs
    read and the intervals written.  Raises ValueError when one query name
    comes with two lengths."""
    ids, _, _ = native.first_seen_ids(t.qname)
    qlen = t.qlen[native.first_rows(ids)]
    bad = np.flatnonzero(t.qlen != qlen[ids])
    if len(bad):
        raise ValueError(f"query {t.qname[bad[0]]!r} has inconsistent "
                         f"lengths")
    run_off, istart, iend, n_runs = native.tile_intervals(
        t.off, t.ops, t.lens, t.qstart)
    phases.count(runs=n_runs, intervals=len(istart))
    return ((np.cumsum(qlen) - qlen)[ids], run_off, istart, iend,
            int(qlen.sum()))


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
    launch on its row's first device over the positions of its own
    sequences.
    Records on different sequences commute, so the levels do not depend on
    the mesh.  Without one, all sequences are one block on
    ``devconf.device()``."""
    n = len(t)
    if n == 0:
        return np.full(0, EMPTY_TILE_LEVEL, dtype=np.int64)
    rows = ([devconf.device()] if mesh is None
            else [row[0] for row in mesh.devices])
    with phases.timed("intervals"):
        arena_off, run_off, istart, iend, _ = sweep_arguments(t)
        # the sequences by arena offset, which ascends in first-seen order
        # (a sequence of no bases shares the next one's and goes with it)
        seq_off, seq_of = np.unique(arena_off, return_inverse=True)
        size = -(-len(seq_off) // len(rows))
        starts = seq_off[::size]
        block = seq_of // size
        order = np.asarray(order, dtype=np.int64)
    levels = np.full(n, EMPTY_TILE_LEVEL, dtype=np.int64)
    shared: dict = {}                  # the CSR arguments on each device
    launched = []
    for b, dev in enumerate(rows[: len(starts)]):
        sub = order[block[order] == b]
        with phases.timed("upload", dev):
            if dev not in shared:
                shared[dev] = [devconf.upload(a, dev)
                               for a in (run_off, istart, iend)]
            # the block's positions start at its first sequence; records of
            # other blocks are not in its order, so their offsets are unread
            args = [devconf.upload(a, dev)
                    for a in (sub, arena_off - int(starts[b]))]
        with phases.timed("K5"):
            launched.append((sub, tile_sweep(args[0], args[1], *shared[dev],
                                             cap)))
    with phases.timed("K5"):          # ends with the readbacks
        for sub, lv in launched:
            levels[sub] = devconf.to_host_i64(lv)[sub]
    return levels
