"""Multi-process execution of the fused pipeline (counterpart of
paffy_tpu/parallel/distributed.py: ``process_info`` :51,
``_local_shard_names`` :65, ``run_pipeline_multihost`` :80, ``_main``
:163).

The reference's distributed form is shell-level: ``paffy split_file``
shards per contig, each shard's ``add_mismatches | chain | tile | trim``
runs as a background job, and the outputs are concatenated in shard order
(tests/paf_pipeline_test.sh:50-71).  Here:

  * ``distenv.initialize_from_env`` joins a ``torch.distributed`` gloo
    group (one process per host, env-gated: a no-op single-process);
  * ``run_pipeline_multihost`` gives contig shards to processes round
    robin, runs each local shard's fused stage over the process's
    (data, seq) mesh (parallel/pipeline.make_mesh over
    ``devconf.devices()``; with ``use_mesh=False``, the mesh-less
    ``pipeline_stage`` on the process's first device), writes one PAF file
    per contig group, waits at a barrier, and has process 0 concatenate the
    files in group order.

Across processes the only communication is the barrier and the files, as
in the reference's share-nothing shards.

CLI: ``python -m paffy_tpu_torch.parallel.distributed in.paf seqs.fa
out.paf [--shards N] [--workdir D] [--by-target]``, once per process with
the PAFFY_TPU_* variables set (or alone with none).  Every process sees
every visible device (``devconf.devices()``); give each its own cards with
CUDA_VISIBLE_DEVICES where several run on one host.
"""

from __future__ import annotations

import os
import sys

import torch.distributed as dist

from paffy_tpu_torch import devconf
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.core.model import PafTable
from paffy_tpu_torch.distenv import coordination_barrier, initialize_from_env
from paffy_tpu_torch.ops.mismatch import SequencePool
from paffy_tpu_torch.parallel.pipeline import make_mesh
from paffy_tpu_torch.parallel.runner import (assign_shards, pipeline_stage,
                                             sharded_pipeline_stage,
                                             split_by_contig)


def process_info() -> tuple[int, int]:
    """(process index, process count): the group's rank and world size, or
    (0, 1) single-process."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _local_shard_names(t: PafTable, groups, shards, pidx: int,
                       pcount: int) -> set[str]:
    """The sequence names of the shards process ``pidx`` runs: its pool
    holds only these, as the reference's per-shard processes read only the
    sequences their records name (impl/paf_view.c:127-134)."""
    names: set[str] = set()
    for s in range(pidx, len(shards), pcount):
        for gi in shards[s]:
            names.update(t.qname[groups[gi]].tolist())
            names.update(t.tname[groups[gi]].tolist())
    return names


def run_pipeline_multihost(t: PafTable, pool: SequencePool, workdir: str,
                           n_shards: int | None = None,
                           by_query: bool = True,
                           use_mesh: bool = True) -> PafTable | None:
    """The fused pipeline with its contig shards spread over processes.

    Every process calls this with the same inputs (paffy_tpu's takes the
    sequences as a dict; here a pool, of which each process keeps only its
    own shards' sequences).  Shard ``s`` runs on process ``s %
    process_count`` and writes ``workdir/shard_{gi:06d}.paf`` per contig
    group, atomically (a rerun over a workdir with a torn file rewrites
    it).  After a barrier, process 0 concatenates every group's file in
    group order and returns the table; the others return None.  The bytes
    equal a single-process ``run_pipeline``'s.

    With ``use_mesh`` (the default) and more than one local device or
    process, each shard runs ``sharded_pipeline_stage`` over a mesh of the
    local devices; without it, ``pipeline_stage`` on ``devconf.device()``,
    as paffy_tpu's ``use_mesh=False``.  The bytes are the same.

    ``workdir`` must be on a filesystem every process sees: the files are
    the interconnect.  With more than one process each first drops a probe
    file and, after a barrier, checks that it sees every other's, failing
    before any shard work on storage that is not shared.
    """
    pidx, pcount = process_info()
    groups = split_by_contig(t, by_query=by_query)
    if not groups:
        return t if pidx == 0 else None
    if n_shards is None:
        n_shards = max(pcount, 1)
    lens = t.qlen if by_query else t.tlen
    shards = assign_shards(groups, [int(lens[g[0]]) for g in groups],
                           n_shards)
    # a missing name fails at lookup with the reference's message
    # (SequencePool.offsets_for), not here
    pool = pool.subset(sorted(_local_shard_names(t, groups, shards, pidx,
                                                 pcount)))
    mesh = None
    if use_mesh:
        local = devconf.devices()
        if len(local) > 1 or pcount > 1:
            mesh = make_mesh(local)

    os.makedirs(workdir, exist_ok=True)
    if pcount > 1:                    # fail fast on a workdir not shared
        with open(os.path.join(workdir, f".reach_p{pidx}"), "w") as fh:
            fh.write("ok\n")
        coordination_barrier("paffy_workdir_probe")
        missing = [i for i in range(pcount) if not os.path.exists(
            os.path.join(workdir, f".reach_p{i}"))]
        if missing:
            raise RuntimeError(
                f"workdir {workdir!r} is not shared across processes "
                f"(process {pidx} cannot see probe files from processes "
                f"{missing}); the shard gather requires a shared filesystem")
    for s in range(pidx, len(shards), pcount):
        for gi in shards[s]:
            sub = t.take(groups[gi])
            out = (sharded_pipeline_stage(sub, pool, mesh)
                   if mesh is not None else pipeline_stage(sub, pool))
            path = os.path.join(workdir, f"shard_{gi:06d}.paf")
            tmp = f"{path}.tmp{pidx}"
            with open(tmp, "wb") as fh:
                fh.write(pafio.serialize_paf_bytes(out))
            os.replace(tmp, path)      # atomic: reruns are idempotent

    coordination_barrier("paffy_pipeline_shards")
    if pidx != 0:
        return None
    blobs = []
    for gi in range(len(groups)):
        with open(os.path.join(workdir, f"shard_{gi:06d}.paf"), "rb") as fh:
            blobs.append(fh.read())
    return pafio.parse_paf_data(b"".join(blobs))


def _main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="paffy_tpu_torch.parallel.distributed",
        description="multi-process fused pipeline (add_mismatches|chain|"
                    "tile|trim), one process per host")
    p.add_argument("paf")
    p.add_argument("fasta")
    p.add_argument("out")
    p.add_argument("--shards", type=int, default=None)
    p.add_argument("--workdir", default=None)
    p.add_argument("--by-target", action="store_true")
    a = p.parse_args(argv)

    initialize_from_env()
    try:
        with open(a.paf, "rb") as fh:
            t = pafio.parse_paf_data(fh.read())
        res = run_pipeline_multihost(
            t, SequencePool.from_fasta_files([a.fasta]),
            a.workdir or (a.out + ".shards"), n_shards=a.shards,
            by_query=not a.by_target)
        if res is not None:
            with open(a.out, "wb") as fh:
                fh.write(pafio.serialize_paf_bytes(res))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
