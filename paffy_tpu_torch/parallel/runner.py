"""The fused per-contig pipeline (counterpart of
paffy_tpu/parallel/runner.py: ``split_by_contig`` :33, ``assign_shards``
:49, ``pipeline_stage`` :65, ``sharded_pipeline_stage`` :83,
``run_pipeline`` :115, ``concat_tables`` :159).

The reference splits a PAF per contig (paffy split_file) and runs
``add_mismatches | chain | tile | trim`` on each shard
(tests/paf_pipeline_test.sh:38-67).  Here records are grouped by contig,
the groups are balanced over shards by contig length, each group runs the
fused stage, and the outputs are concatenated in group order, so the bytes
do not depend on the shard count.  On the one card of the port the groups
run one after another, with no thread pool: the output is in group order
either way.  The stage's device work is the port's: K2 and K4 in the
encode, K6 in the chain, K5 in the tile.  With a mesh
(parallel/pipeline.py), ``sharded_pipeline_stage`` puts the chain's groups
and the tile's query sequences on the mesh's data rows.
"""

from __future__ import annotations

from dataclasses import fields, replace
from functools import partial

import numpy as np

from paffy_tpu_torch import phases
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.core.model import PafTable
from paffy_tpu_torch.ops.chain import paf_chain
from paffy_tpu_torch.ops.chain_device import chain_groups_device
from paffy_tpu_torch.ops.mismatch import SequencePool, encode_mismatches
from paffy_tpu_torch.ops.tailtrim import trim_unreliable_tails
from paffy_tpu_torch.ops.tile import (assign_tile_levels_sharded,
                                      tile_sort_order)


def split_by_contig(t: PafTable, by_query: bool = True) -> list[np.ndarray]:
    """Record indices grouped by contig name, groups in first-seen order
    (the split_file axis, impl/paf_split_file.c:142-170)."""
    groups: dict[str, list[int]] = {}
    for i, name in enumerate((t.qname if by_query else t.tname).tolist()):
        groups.setdefault(name, []).append(i)
    return [np.array(g, dtype=np.int64) for g in groups.values()]


def assign_shards(groups: list[np.ndarray], lengths: list[int],
                  n_shards: int) -> list[list[int]]:
    """Contig groups balanced over shards by total contig length (greedy,
    longest first: the load balance of split_file's bin packing); each
    shard's groups in ascending order."""
    loads = [0] * n_shards
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    for gi in np.argsort([-x for x in lengths], kind="stable").tolist():
        s = int(np.argmin(loads))
        shards[s].append(gi)
        loads[s] += lengths[gi]
    for s in shards:
        s.sort()
    return shards


def pipeline_stage(t: PafTable, pool: SequencePool,
                   trim_identity: float = 0.05,
                   trim_fraction: float = 1.0) -> PafTable:
    """One shard's fused pipeline, add_mismatches | chain | tile | trim
    (tests/paf_pipeline_test.sh:57-60), on parsed cigars throughout."""
    return sharded_pipeline_stage(t, pool, None, trim_identity,
                                  trim_fraction)


def sharded_pipeline_stage(t: PafTable, pool: SequencePool, mesh,
                           trim_identity: float = 0.05,
                           trim_fraction: float = 1.0) -> PafTable:
    """``pipeline_stage`` with its chain and tile on ``mesh``'s data rows
    (None: on ``devconf.device()``): the chain's (qname, tname) groups
    through chain_groups_device(mesh=), the tile's query sequences through
    assign_tile_levels_sharded.  The encode runs on the pool's device.
    paffy_tpu's docstring names sharded_view_stats as the stage's column
    stats step, but its code runs the unsharded encode
    (paffy_tpu/parallel/runner.py:92-93, :102); this follows the code.  The
    bytes do not depend on the mesh."""
    t = encode_mismatches(t, pool)
    with phases.timed("check"):
        pafio.paf_check(t)
    t = paf_chain(t, dp_many=partial(chain_groups_device, mesh=mesh))
    with phases.timed("order"):
        order = tile_sort_order(t)
    t = replace(t, tile_level=assign_tile_levels_sharded(t, order, mesh=mesh))
    with phases.timed("take"):
        t = t.take(order)
    with phases.timed("trim"):
        t = trim_unreliable_tails(t, trim_identity, trim_fraction)
    with phases.timed("check"):
        pafio.paf_check(t)
    return t


def run_pipeline(t: PafTable, seqs, n_shards: int = 1,
                 by_query: bool = True, mesh=None) -> PafTable:
    """The fused pipeline per contig group, concatenated in group order.
    ``seqs`` is {name: sequence} or a SequencePool.  With ``mesh``, each
    group runs ``sharded_pipeline_stage``; the bytes are the same."""
    pool = seqs if isinstance(seqs, SequencePool) else SequencePool(seqs)
    groups = split_by_contig(t, by_query=by_query)
    if not groups:
        return t
    lens = t.qlen if by_query else t.tlen
    shards = assign_shards(groups, [int(lens[g[0]]) for g in groups],
                           n_shards)
    out = {gi: sharded_pipeline_stage(t.take(groups[gi]), pool, mesh)
           for shard in shards for gi in shard}
    return concat_tables([out[gi] for gi in range(len(groups))])


def concat_tables(tables: list[PafTable]) -> PafTable:
    """One table of the rows of ``tables`` (at least one, parsed cigars),
    in order."""
    if any(x.raw_cg is not None for x in tables):
        raise ValueError("concat_tables takes tables with parsed cigars")
    cols = {}
    for f in fields(PafTable):
        if f.name == "raw_cg":
            continue
        arrs = [getattr(x, f.name) for x in tables]
        if f.name == "off":
            base = np.cumsum([0] + [a[-1] for a in arrs[:-1]])
            arrs = [arrs[0]] + [a[1:] + b for a, b in zip(arrs[1:], base[1:])]
        cols[f.name] = np.concatenate(arrs)
    return PafTable(**cols)
