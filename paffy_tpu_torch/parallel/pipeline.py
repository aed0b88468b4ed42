"""The (data, seq) mesh and the mesh-sharded column stats (counterpart of
paffy_tpu/parallel/pipeline.py: ``make_mesh`` :50, ``shard_records`` :87,
``sharded_view_stats`` :171, ``column_counts_multichip`` :200).

A mesh is a dp x sp grid of torch devices with two axes, as paffy_tpu's:

  * ``data`` -- record groups: the batch is cut into dp contiguous groups,
    group g on row g;
  * ``seq``  -- column ranges within a group: a group's pieces are cut
    into sp contiguous ranges of near-equal columns, range s on slot
    (g, s).

No XLA places the collectives here, so the step is written out: K7
(ops/group_stats.py) runs on every slot that holds pieces, with ``ext`` on
that slot's device (``SequencePool.ext_on``); the slots' partial (matches,
columns) are added on the row's first device, and the totals on the mesh's
first device, by device-to-device copies and adds.  One process needs no
NCCL for that.  paffy_tpu's chunk grid, phase views and roll chain work
around XLA's gathers on a TPU and are not ported: K7 walks K1's piece
table.

A device may fill several slots.  The port's chip runs have one card, so a
(4, 2) mesh there is 8 slots on cuda:0, as paffy_tpu's tests run 8 virtual
CPU devices; the CPU tests use 8 ``cpu`` slots.  Results do not depend on
the mesh's shape or on which devices fill it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from paffy_tpu_torch import devconf, phases
from paffy_tpu_torch.core.model import PafTable
from paffy_tpu_torch.ops.compare import build_piece_table
from paffy_tpu_torch.ops.group_stats import group_stats
from paffy_tpu_torch.ops.mismatch import SequencePool
from paffy_tpu_torch.ops.segments import bucket_size, build_m_column_batch


class Mesh:
    """A dp x sp grid of devices; ``shape`` is {"data": dp, "seq": sp}."""

    def __init__(self, rows):
        self.devices = [[torch.device(d) for d in row] for row in rows]
        self.shape = {"data": len(self.devices),
                      "seq": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]


def make_mesh(devices=None, dp: int | None = None,
              sp: int | None = None) -> Mesh:
    """A (data, seq) mesh over ``devices`` (default: ``devconf.devices()``)
    with paffy_tpu's shape rule: data parallelism first, a seq axis of 2
    when the device count is even and > 1."""
    if devices is None:
        devices = devconf.devices()
    n = len(devices)
    if dp is None:
        sp = sp or (2 if n % 2 == 0 and n > 1 else 1)
        dp = n // sp
    else:
        sp = sp or n // dp
    if dp * sp != n:
        raise AssertionError(f"mesh {dp}x{sp} != {n} devices")
    return Mesh([devices[r * sp: (r + 1) * sp] for r in range(dp)])


@dataclass
class ShardedPieceBatch:
    """A batch cut into record groups, each with its piece table.

    ``tables[g]`` is int64 [4, n_pieces] (ops/compare.build_piece_table)
    with the group's LOCAL record index as the slot; ``n_cols[g]`` its M
    columns; ``group_of_record`` and ``index_in_group`` map each record of
    the batch to its group and slot; ``rec_pad`` is the slot count of every
    group's outputs.
    """

    tables: list[np.ndarray]
    n_cols: np.ndarray
    group_of_record: np.ndarray
    index_in_group: np.ndarray
    rec_pad: int


def shard_records(t: PafTable, pool: SequencePool,
                  n_groups: int) -> ShardedPieceBatch:
    """Cut ``t`` into ``n_groups`` contiguous record groups (paffy_tpu's
    linspace bounds) and build each group's piece table."""
    n = len(t)
    bounds = np.linspace(0, n, n_groups + 1).astype(np.int64)
    group_of_record = np.zeros(n, dtype=np.int64)
    index_in_group = np.zeros(n, dtype=np.int64)
    tables, n_cols = [], []
    for g, (lo, hi) in enumerate(zip(bounds[:-1].tolist(),
                                     bounds[1:].tolist())):
        group_of_record[lo:hi] = g
        index_in_group[lo:hi] = np.arange(hi - lo)
        sub = t.take(np.arange(lo, hi))
        b = build_m_column_batch(sub, pool.offsets_for(sub.qname, "query"),
                                 pool.offsets_for(sub.tname, "target"))
        k = b.n_mops
        tables.append(build_piece_table(b.lens[:k], b.qpos0[:k],
                                        b.tpos0[:k], b.rev[:k], b.rec[:k],
                                        pool.pool_len, hi - lo))
        n_cols.append(b.n_cols)
    return ShardedPieceBatch(
        tables=tables, n_cols=np.array(n_cols, dtype=np.int64),
        group_of_record=group_of_record, index_in_group=index_in_group,
        rec_pad=bucket_size(int(np.diff(bounds).max(initial=0)), minimum=8))


def seq_ranges(n: np.ndarray, sp: int) -> list[tuple[int, int]]:
    """``sp`` contiguous ranges [lo, hi) of pieces with column counts
    ``n``, cut at piece boundaries so that each holds near 1/sp of the
    columns (a range may be empty)."""
    cum = np.cumsum(n)
    total = int(cum[-1]) if len(cum) else 0
    cuts = np.searchsorted(cum, [total * s // sp for s in range(1, sp)],
                           side="right").tolist()
    edges = [0, *cuts, len(n)]
    return list(zip(edges[:-1], edges[1:]))


def _row_stats(pool: SequencePool, table: np.ndarray, row, rec_pad: int):
    """(match, cols, totals) of one record group, on its row's first device:
    K7 on each slot of the row with pieces, its seq range's partial sums
    added into the first device's."""
    head = row[0]
    acc = [torch.zeros(k, dtype=torch.int64, device=head)
           for k in (rec_pad, rec_pad, 2)]
    for dev, (lo, hi) in zip(row, seq_ranges(table[2], len(row))):
        if hi == lo:
            continue
        out = acc if dev == head else [torch.zeros_like(a, device=dev)
                                       for a in acc]
        group_stats(pool.ext_on(dev), devconf.upload(table[:, lo:hi], dev),
                    *out)
        if out is not acc:
            for a, o in zip(acc, out):
                a += o.to(head)
    return acc


def sharded_view_stats(mesh: Mesh, pool: SequencePool,
                       b: ShardedPieceBatch):
    """The stats step over ``mesh``: group g on data row g, its pieces cut
    over the row's seq slots.  Returns int64 numpy (matches [G, rec_pad],
    mismatches [G, rec_pad], totals [matches, mismatches]), zero past each
    group's records.  Takes the pool where paffy_tpu takes its ``ext``
    array: each slot reads ``ext`` on its own device."""
    if len(b.tables) != mesh.shape["data"]:
        raise ValueError(f"{len(b.tables)} record groups on a mesh of "
                         f"{mesh.shape['data']} data rows")
    with phases.timed("K7"):
        rows = [_row_stats(pool, tab, row, b.rec_pad)
                for tab, row in zip(b.tables, mesh.devices)]
        totals = sum(tot.to(mesh.first) for _, _, tot in rows)
        m = np.stack([devconf.download(m) for m, _, _ in rows])
        cols = np.stack([devconf.download(c) for _, c, _ in rows])
        totals = devconf.download(totals)
    return m, cols - m, totals


def column_counts_multichip(t: PafTable, pool: SequencePool, mesh: Mesh):
    """Per-record (matches, mismatches) and their totals over ``mesh``,
    one record group per data row, back in record order."""
    with phases.timed("shard"):
        b = shard_records(t, pool, mesh.shape["data"])
    m, x, totals = sharded_view_stats(mesh, pool, b)
    return (m[b.group_of_record, b.index_in_group],
            x[b.group_of_record, b.index_in_group], totals)
