"""K5, the greedy tile sweep on the device (counterpart of
paffy_tpu/ops/tile_device.py: ``_tile_scan`` :23, ``_tile_scan_groups``
:78).

``tile_sweep`` takes the arguments of the C sweep (native.tile_sweep)
without its arena, as tensors: the processing order, each record's offset
into one position space (each distinct query sequence's positions laid end
to end) and the records' aligned query intervals in CSR form (run_off,
istart, iend; a record's intervals disjoint and ascending, as
native.match_intervals gives them).  Taken in order, each record adds one
to the count of each of its bases, saturating at the cap; it returns the
levels: the ((n+1)//2)-th smallest of a record's n new counts, or
EMPTY_TILE_LEVEL without an aligned base or outside the order.

On a CUDA tensor the wrapper builds the tile plan (``tile_plan``, torch
ops on the card) and launches the CUDA kernels (csrc/tile_sweep.cu): one
block per tile of ``tile`` positions, its counts in shared memory, and a
histogram row per record in device memory from which a second kernel takes
the medians.  The rows of one launch fit HIST_BUDGET bytes: the plan cuts
the processing order into batches whose rows fit, and each batch is one
launch, its tiles' counts carried in device memory from the batch before.
On a CPU tensor it runs ``tile_sweep_plain``, the sequential sweep over one
count arena.  ``tile_sweep_tiled_plain`` is the plain emulation of the
kernel's decomposition, batches included, for the tests.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import NamedTuple

import torch

from paffy_tpu_torch import devconf, kernels, phases
from paffy_tpu_torch.ops.coverage import EMPTY_TILE_LEVEL, SATURATION

TILE = 8192             # positions per tile: 16 KB of counts per block
MAX_TILE = 65536        # 128 KB of counts, within a block's shared memory
# bytes of histogram rows one launch may take; rows are 4 bytes per count
# value a record can reach (tile_plan), so one row takes at most
# 4 * SATURATION bytes
HIST_BUDGET = 1 << 30


class TilePlan(NamedTuple):
    """K5's work list.  ``tile_ids``: the tiles that some record touches,
    ascending; ``pair_off``: CSR over them of ``pair_pos``, the processing
    positions (indices into the order) of the records whose span meets
    each tile, ascending; ``row_off``: each processing position's histogram
    row (m + 1 offsets for an order of m records, rows of B_r bins, B_r = 0
    for a record without a span); ``batch_off``: the batches, consecutive
    ranges [batch_off[k], batch_off[k + 1]) of processing positions whose
    rows fit HIST_BUDGET bytes; ``batch_row``: row_off at each of them;
    ``n_bins``: the rows' total."""
    tile_ids: torch.Tensor
    pair_off: torch.Tensor
    pair_pos: torch.Tensor
    row_off: torch.Tensor
    batch_off: list
    batch_row: list
    n_bins: int


def tile_plan(order, arena_off, run_off, istart, iend, cap: int = SATURATION,
              tile: int = TILE) -> TilePlan:
    """The (tile, record) pairs of a sweep, on the arguments' device.

    A record's span runs from its first interval's start to its last
    interval's end (the intervals ascend), offset by arena_off; it meets
    the tiles span_lo // tile .. (span_hi - 1) // tile.  The pairs are
    made in processing order and sorted stably by tile, so a batch's pairs
    are one sub-range of each tile's list.  A record's new count at a
    position is 1 + the earlier records covering it, each of them an
    earlier pair of that position's tile (in its batch or an earlier one),
    so it is at most B_r = min(cap, max over r's pairs of 1 + its rank in
    the tile): r's row has B_r bins.  The rows are laid out in processing
    order and cut greedily into batches of at most HIST_BUDGET bytes.
    Raises ValueError when ``order`` repeats a record or leaves [0, n), and
    when HIST_BUDGET is below one record's row."""
    dev = order.device
    n, n_iv, m = run_off.numel() - 1, istart.numel(), order.numel()
    if n == 0 and m:
        raise ValueError("order must list distinct records of [0, n)")
    z = torch.zeros(1, dtype=torch.int64, device=dev)
    # indexed in range before the check, which shares the first readback
    rec = order.clamp(0, max(n - 1, 0))
    bad_order = ((order < 0) | (order >= n)).sum() + (
        torch.bincount(rec, minlength=n) > 1).sum()
    a, e = run_off[rec], run_off[rec + 1]
    has = e > a
    if n_iv:
        base = arena_off[rec]
        lo = base + istart[a.clamp(max=n_iv - 1)]
        hi = base + iend[(e - 1).clamp(min=0)]
        has &= hi > lo
    else:
        lo = hi = a
    t_lo = torch.div(lo, tile, rounding_mode="floor")
    t_hi = torch.div(hi - 1, tile, rounding_mode="floor")
    cnt = torch.where(has, t_hi - t_lo + 1, 0)
    n_pairs, bad = devconf.readback(torch.stack([cnt.sum(), bad_order]))
    if bad:
        raise ValueError("order must list distinct records of [0, n)")
    first = torch.cumsum(cnt, 0) - cnt
    pos = torch.repeat_interleave(torch.arange(m, device=dev), cnt,
                                  output_size=n_pairs)
    tile_of = (t_lo[pos] - first[pos]
               + torch.arange(n_pairs, dtype=torch.int64, device=dev))
    tile_sorted, perm = torch.sort(tile_of, stable=True)
    pair_pos = pos[perm]
    tile_ids, per_tile = torch.unique_consecutive(tile_sorted,
                                                  return_counts=True)
    pair_off = torch.cat([z, torch.cumsum(per_tile, 0)])
    in_tile = (torch.arange(n_pairs, device=dev) - torch.repeat_interleave(
        pair_off[:-1], per_tile, output_size=n_pairs))
    bins = torch.zeros(m, dtype=torch.int64, device=dev).scatter_reduce_(
        0, pair_pos, (in_tile + 1).clamp(max=cap), "amax")
    row_off = torch.cat([z, torch.cumsum(bins, 0)])
    n_bins, = devconf.readback(row_off[-1:])
    batch_off, batch_row = [0, m], [0, n_bins]
    if 4 * n_bins > HIST_BUDGET:
        widest = int(bins.max())
        if 4 * widest > HIST_BUDGET:
            raise ValueError(f"HIST_BUDGET ({HIST_BUDGET} bytes) is below "
                             f"one record's histogram row ({4 * widest} "
                             f"bytes)")
        # each batch ends at the last position whose row end fits
        batch_off, batch_row, lim = [0], [0], HIST_BUDGET // 4
        while batch_off[-1] < m:
            k = torch.searchsorted(row_off, row_off[batch_off[-1]] + lim,
                                   right=True) - 1
            k, r = devconf.readback(torch.stack([k, row_off[k]]))
            batch_off.append(k)
            batch_row.append(r)
    return TilePlan(tile_ids, pair_off, pair_pos, row_off, batch_off,
                    batch_row, n_bins)


def tile_sweep_tiled_plain(order, arena_off, run_off, istart, iend,
                           cap: int = SATURATION,
                           tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch emulation of the kernel's decomposition: per batch of
    ``tile_plan``, per tile with pairs in the batch, its counts (zero in
    the tile's first batch, else those its previous batch left), the
    batch's records of it in order, each record's intervals in the tile
    found by binary search of its CSR slice and clipped to it, its new
    counts added to its histogram row in the batch's histogram; then the
    medians of the batch's rows.  Equals ``tile_sweep_plain`` at any
    HIST_BUDGET."""
    plan = tile_plan(order, arena_off, run_off, istart, iend, cap, tile)
    dev = order.device
    ro, ao, recs = run_off.tolist(), arena_off.tolist(), order.tolist()
    row, pos = plan.row_off.tolist(), plan.pair_pos.tolist()
    po = plan.pair_off.tolist()
    levels = torch.full((len(ro) - 1,), EMPTY_TILE_LEVEL, dtype=torch.int64,
                        device=dev)
    carried = {}                       # tile index -> its counts
    for p0, p1 in zip(plan.batch_off[:-1], plan.batch_off[1:]):
        base = row[p0]
        hist = torch.zeros(row[p1] - base, dtype=torch.int64, device=dev)
        for b, t in enumerate(plan.tile_ids.tolist()):
            k0 = bisect_left(pos, p0, po[b], po[b + 1])
            k1 = bisect_left(pos, p1, k0, po[b + 1])
            if k0 == k1:
                continue
            t0 = t * tile
            counts = carried.pop(b) if k0 > po[b] else torch.zeros(
                tile, dtype=torch.int64, device=dev)
            for k in pos[k0:k1]:
                r = recs[k]
                s = istart[ro[r]: ro[r + 1]] + (ao[r] - t0)
                e = iend[ro[r]: ro[r + 1]] + (ao[r] - t0)
                j0 = int(torch.searchsorted(e, 0, right=True))
                j1 = int(torch.searchsorted(s, tile))
                s, e = s[j0:j1].clamp(min=0), e[j0:j1].clamp(max=tile)
                ln = (e - s).clamp(min=0)
                n_new = int(ln.sum())
                if n_new == 0:
                    continue
                at = (torch.repeat_interleave(s - (torch.cumsum(ln, 0) - ln),
                                              ln, output_size=n_new)
                      + torch.arange(n_new, device=dev))
                v = (counts[at] + 1).clamp(max=cap)
                counts[at] = v
                hist[row[k] - base: row[k + 1] - base] += torch.bincount(
                    v - 1, minlength=row[k + 1] - row[k])
            if k1 < po[b + 1]:
                carried[b] = counts
        # each row's ((n+1)//2)-th smallest count (bin v - 1 counts new
        # count v)
        for k in range(p0, p1):
            acc = torch.cumsum(hist[row[k] - base: row[k + 1] - base], 0)
            if acc.numel() and int(acc[-1]):
                levels[recs[k]] = int(torch.searchsorted(
                    acc, (int(acc[-1]) + 1) // 2)) + 1
    return levels


def tile_sweep_plain(order, arena_off, run_off, istart, iend,
                     cap: int = SATURATION, arena=None) -> torch.Tensor:
    """Plain PyTorch K5, the sequential sweep: one record at a time, its
    bases gathered from its intervals, incremented in one int16 count
    arena, written back and their k-th value taken.  ``arena`` (int16,
    updated in place; the uint16 counts the C sweep keeps, as bits) is
    made zero when not given."""
    dev = order.device
    if arena is None:
        size = (int(arena_off[order].max()) + int(iend.max())
                if order.numel() and iend.numel() else 0)
        arena = torch.zeros(max(size, 1), dtype=torch.int16, device=dev)
    levels = torch.full((run_off.numel() - 1,), EMPTY_TILE_LEVEL,
                        dtype=torch.int64, device=dev)
    ro, ao = run_off.tolist(), arena_off.tolist()
    for i in order.tolist():
        s, e = istart[ro[i]: ro[i + 1]], iend[ro[i]: ro[i + 1]]
        ln = e - s
        n = int(ln.sum()) if ln.numel() else 0
        if n == 0:
            continue
        pos = (torch.repeat_interleave(s - (torch.cumsum(ln, 0) - ln), ln,
                                       output_size=n)
               + torch.arange(n, device=dev) + ao[i])
        c = torch.clamp(arena[pos].to(torch.int32) + 1, max=cap)
        arena[pos] = c.to(torch.int16)
        levels[i] = torch.kthvalue(c, (n + 1) // 2).values
    return levels


def tile_sweep(order, arena_off, run_off, istart, iend, cap: int = SATURATION,
               tile: int = TILE) -> torch.Tensor:
    """int64 [n_records] tile levels: the CUDA kernels for CUDA tensors,
    one launch per batch of the plan, the plain sequential version for CPU
    tensors.  Every argument is a 1-D int64 tensor on one device; ``tile``
    (1..MAX_TILE) is the kernel's tile of positions.  The plan's cost is
    timed as the phase "K5 tiles", its readbacks (devconf.readback)
    counted there as waits on the card while tracing."""
    args = (order, arena_off, run_off, istart, iend)
    if any(x.dtype != torch.int64 or x.dim() != 1 for x in args):
        raise ValueError("order, arena_off, run_off, istart and iend must be "
                         "1-D int64 tensors")
    if any(x.device != order.device for x in args):
        raise ValueError("every tensor must be on one device")
    if not 1 <= cap <= SATURATION:
        raise ValueError(f"cap must be in [1, {SATURATION}], got {cap}")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile must be in [1, {MAX_TILE}], got {tile}")
    if arena_off.numel() != run_off.numel() - 1 or \
            istart.numel() != iend.numel():
        raise ValueError("arena_off and run_off must cover the same records, "
                         "istart and iend the same intervals")
    if order.device.type == "cpu":
        return tile_sweep_plain(order, arena_off, run_off, istart, iend, cap)
    dev = kernels.check_device(order.device)
    n = run_off.numel() - 1
    levels = torch.full((n,), EMPTY_TILE_LEVEL, dtype=torch.int64,
                        device=order.device)
    if n == 0 or order.numel() == 0:
        return levels
    args = [x.contiguous() for x in args]
    with phases.timed("K5 tiles"):
        plan = tile_plan(*args, cap, tile)
    n_tiles = plan.tile_ids.numel()
    rows = [b - a for a, b in zip(plan.batch_row[:-1], plan.batch_row[1:])]
    hist = torch.empty(max(rows), dtype=torch.int32, device=order.device)
    # the counts a batch leaves for the next, 2 bytes per position of each
    # tile; one batch needs none
    carry = (torch.empty(n_tiles * tile, dtype=torch.int16,
                         device=order.device) if len(rows) > 1 else None)
    lib, stream = kernels.load(), kernels.stream_of(levels)
    for b, width in enumerate(rows):
        p0, p1 = plan.batch_off[b], plan.batch_off[b + 1]
        base = plan.batch_row[b]
        hist[:width].zero_()
        if n_tiles:
            kernels.check(lib.paffy_tile_walk(
                dev, n_tiles, plan.tile_ids.data_ptr(),
                plan.pair_off.data_ptr(), plan.pair_pos.data_ptr(),
                *(x.data_ptr() for x in args), plan.row_off.data_ptr(),
                hist.data_ptr(), base, p0, p1,
                None if carry is None else carry.data_ptr(), cap, tile,
                stream), "tile_sweep")
        kernels.check(lib.paffy_tile_median(
            dev, p0, p1, args[0].data_ptr(), plan.row_off.data_ptr(),
            hist.data_ptr(), base, levels.data_ptr(), stream), "tile_sweep")
        kernels.count_launch("tile_sweep")
    return levels
