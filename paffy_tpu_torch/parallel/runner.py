"""The fused per-contig pipeline (counterpart of
paffy_tpu/parallel/runner.py: ``split_by_contig`` :33, ``assign_shards``
:49, ``pipeline_stage`` :65, ``sharded_pipeline_stage`` :83,
``run_pipeline`` :115, ``concat_tables`` :159).

The reference splits a PAF per contig (paffy split_file) and runs
``add_mismatches | chain | tile | trim`` on each shard as background jobs
(tests/paf_pipeline_test.sh:38-67).  Here records are grouped by contig,
the groups are balanced over shards by contig length, each group runs the
fused stage, and the outputs are concatenated in group order, so the bytes
do not depend on the shard count or on the order in which groups finish.
Without a mesh, the groups run in ``PAFFY_TPU_PIPELINE_THREADS`` worker
threads (default min(cpu count, 4), as in paffy_tpu), the in-process
counterpart of those jobs: one group's native C passes (which release the
GIL) overlap another group's kernels, and several groups' kernels run on
the card at once, since each worker runs its groups on a CUDA stream of
its own.  The stage's device work is the port's: K2 and K4 in the encode,
K6 in the chain, K5 in the tile.  With a mesh (parallel/pipeline.py),
``sharded_pipeline_stage`` puts the chain's groups and the tile's query
sequences on the mesh's data rows, and the groups run one after another.

What the workers share, and why it is safe:
  * ``SequencePool.ext`` (K2's output): built once on the caller's stream
    before any worker starts (and built under the pool's lock in any
    case); each worker's stream waits for the caller's first, and the
    caller's waits for every worker's at the end.  ``ext_on``'s copies are
    made under the same lock (the mesh path, which runs no workers).
  * ``kernels.load`` and ``native.get_lib``: built and loaded under their
    locks.  No kernel source keeps host state; K5 and K6 set their shared
    memory attribute with ``cudaFuncSetAttribute`` at each launch, which
    is thread-safe, and every entry point launches on the stream it is
    given (PyTorch's current stream, which is per thread).  The C passes
    of the pipeline keep no static state (paffy_io.cpp's only static, the
    base tables of the column compare, is not on this path).
  * ``kernels.LAUNCHES`` and ``phases.SECONDS``/``SPANS``: updated under
    locks; a phase's device sync is of the current stream, and its
    seconds are summed over the workers.  While tracing, each worker's
    spans descend from its group's ``group`` span, and that from the
    caller's ``run_pipeline`` span, handed to the worker when it starts.
  * ``tile_device.tile_plan``'s and the chain's readbacks, and
    ``devconf.upload``/``download``: on the current stream, through
    PyTorch's pinned host allocator, which is thread-safe and keeps a
    pinned block until its copy's stream has passed it.
  * The input table: each worker reads it (``take``) and writes nothing
    but its own group's tables.
A worker's exception propagates out of ``run_pipeline``: that of the first
failing group in run order, as paffy_tpu's ``ex.map`` gives it.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import fields, replace
from functools import partial

import numpy as np
import torch

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
    group runs ``sharded_pipeline_stage``, one after another; without one,
    the groups run in worker threads (see the module's docstring).  The
    bytes are the same either way."""
    with phases.span("run_pipeline"):
        pool = seqs if isinstance(seqs, SequencePool) else SequencePool(seqs)
        with phases.timed("split"):
            groups = split_by_contig(t, by_query=by_query)
            lens = t.qlen if by_query else t.tlen
            shards = assign_shards(groups, [int(lens[g[0]]) for g in groups],
                                   n_shards)
        if not groups:
            return t

        def run_group(gi: int) -> PafTable:
            with phases.span("group", group=gi, records=len(groups[gi])):
                with phases.timed("gather"):
                    sub = t.take(groups[gi])
                return sharded_pipeline_stage(sub, pool, mesh)

        order = [gi for shard in shards for gi in shard]
        n_workers = min(len(order), int(os.environ.get(
            "PAFFY_TPU_PIPELINE_THREADS", min(os.cpu_count() or 1, 4))))
        if mesh is None and n_workers > 1:
            outs = map_on_streams(run_group, order, n_workers, pool)
        else:
            outs = [run_group(gi) for gi in order]
        out = dict(zip(order, outs))
        with phases.timed("concat"):
            return concat_tables([out[gi] for gi in range(len(groups))])


def map_on_streams(fn, items: list, n_workers: int,
                   pool: SequencePool) -> list:
    """``[fn(x) for x in items]`` in ``n_workers`` threads, each running
    its calls on a CUDA stream of its own on the pool's device (on the
    CPU, in plain threads).  ``pool.ext`` is built first, on the caller's
    stream, and every worker stream waits for it; the caller's stream
    waits for every worker stream before this returns, so what the caller
    later frees or reads is past the workers' work.  Results come in the
    order of ``items``; an exception is that of the first failing item in
    that order.  While tracing, each worker records its spans under the
    caller's innermost open span (phases.handoff)."""
    traced = phases.handoff()
    if pool.device.type != "cuda":
        with ThreadPoolExecutor(max_workers=n_workers,
                                initializer=phases.adopt,
                                initargs=(traced,)) as ex:
            return list(ex.map(fn, items))
    pool.ext                  # K2, once, on the caller's stream
    caller = torch.cuda.current_stream(pool.device)
    streams = [torch.cuda.Stream(pool.device) for _ in range(n_workers)]
    free = queue.SimpleQueue()
    for s in streams:
        s.wait_stream(caller)
        free.put(s)
    local = threading.local()

    def take_stream() -> None:
        phases.adopt(traced)
        local.stream = free.get()

    def on_stream(x):
        with torch.cuda.stream(local.stream):
            return fn(x)

    try:
        with ThreadPoolExecutor(max_workers=n_workers,
                                initializer=take_stream) as ex:
            return list(ex.map(on_stream, items))
    finally:
        for s in streams:
            caller.wait_stream(s)


def concat_tables(tables: list[PafTable]) -> PafTable:
    """One table of the rows of ``tables`` (parsed cigars), in order; an
    empty list gives ``PafTable.empty()``.  A raw-cigar table raises
    AssertionError, as paffy_tpu's assert does (raised, so that ``python
    -O`` keeps it)."""
    if not tables:
        return PafTable.empty()
    if any(x.raw_cg is not None for x in tables):
        raise AssertionError("concat_tables requires parsed-cigar tables")
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
