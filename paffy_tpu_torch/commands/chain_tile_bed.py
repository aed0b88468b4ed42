"""paffy chain, paffy tile and paffy to_bed on the port (counterpart of
paffy_tpu/commands/chain_tile_bed.py: ``chain_main`` :21, ``tile_main``
:46 and ``to_bed_main`` :71; the reference's impl/paf_chain.c,
impl/paf_tile.c and impl/paf_to_bed.c).

The same output bytes and exit codes as paffy_tpu's.  chain reads the
cigars raw (it writes them back as they were), tags the records with their
chains (cn, s1) in input order, K6 running the DP on the device
(ops/chain.py), and writes them by descending score.  tile reads the whole
input, checks the reference's coverage-walk asserts before anything is
written (an assert loses the stdio tail, as the reference's abort does),
and writes the records best-first with their tile levels (tl tag), which
K5 computes on the device (ops/tile.py).  to_bed is host code, as in
paffy_tpu: the coverage of the query sequences (with -n, of the target
sequences too, through the inverted records) as BED rows of equal counts.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from paffy_tpu_torch import phases
from paffy_tpu_torch.commands.common import (base_parser, open_output,
                                             read_table, start, stream_tables,
                                             write_table)
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.core.fasta import read_fasta
from paffy_tpu_torch.ops.coverage import CoverageMap, run_length_rows
from paffy_tpu_torch.ops.transforms import invert, query_walk_violation
from paffy_tpu_torch.utils.logging import log_info


def chain_main(argv) -> int:
    p = base_parser("paffy chain",
                    "Chains the records in the PAF file into chains, rescoring "
                    "them as chains. Chains are indicated with the cn tag.")
    p.add_argument("-g", "--maxGapLength", type=int, default=1000000)
    p.add_argument("-d", "--chainGapOpen", type=int, default=5000)
    p.add_argument("-e", "--chainGapExtend", type=int, default=1)
    p.add_argument("-t", "--trimFraction", type=float, default=1.0)
    args = p.parse_args(argv)
    timer = start(args, "Paffy chain")
    log_info("Maximum gap length : %d", args.maxGapLength)
    log_info("Chain gap open : %d", args.chainGapOpen)
    log_info("Chain gap extend : %d", args.chainGapExtend)
    # the device modules load torch: to_bed, a host command, never imports
    # them
    from paffy_tpu_torch import devconf
    from paffy_tpu_torch.ops.chain import paf_chain_order
    devconf.device()        # no device: raise before reading any input
    # raw cigars, as the reference's read_pafs(parse_cigar=0)
    # (impl/paf_chain.c:128): paf_check then skips the span checks
    with phases.timed("parse"):
        t = read_table(args, parse_cigars=False)
    tagged, perm = paf_chain_order(
        t, gap_open=args.chainGapOpen, gap_extend=args.chainGapExtend,
        max_gap=args.maxGapLength, pct_trim=args.trimFraction)
    with phases.timed("write"):
        write_table(tagged, args, order=perm)
    timer.done()
    return 0


def tile_main(argv) -> int:
    p = base_parser("paffy tile",
                    "Tiles the records in the PAF file along the query sequence")
    args = p.parse_args(argv)
    timer = start(args, "Paffy tile")
    from paffy_tpu_torch import devconf
    from paffy_tpu_torch.ops.tile import assign_tile_levels, tile_sort_order
    devconf.device()        # no device: raise before reading any input
    with phases.timed("parse"):
        t = read_table(args)
    # the walk asserts (column bounds, end of walk, one qlen per name) fire
    # before any output: tile buffers everything until write_pafs
    # (impl/paf_tile.c:150-180)
    with phases.timed("walk check"):
        bad = query_walk_violation(t, {})
    if bad >= 0:
        err = pafio.PafCheckError(
            f"tile: invalid record, {pafio.format_record(t, bad)}")
        err.stdio_lost_tail = True   # an assert: SIGABRT
        raise err
    with phases.timed("order"):
        order = tile_sort_order(t)
    levels = assign_tile_levels(t, order)
    with phases.timed("write"):
        write_table(replace(t, tile_level=levels), args, order=order)
    timer.done()
    return 0


def _walk_abort(what: str, t, bad: int) -> pafio.PafCheckError:
    err = pafio.PafCheckError(
        f"to_bed: invalid {what}, {pafio.format_record(t, bad)}")
    err.stdio_lost_tail = True   # a walk assert: SIGABRT
    return err


def to_bed_main(argv) -> int:
    p = base_parser("paffy to_bed",
                    "Creates a bed file representing the coverage of alignments "
                    "on the query sequences of the paf alignments")
    p.add_argument("-b", "--binary", action="store_true")
    p.add_argument("-e", "--excludeUnaligned", action="store_true")
    p.add_argument("-f", "--excludeAligned", action="store_true")
    p.add_argument("-m", "--minSize", type=int, default=1)
    p.add_argument("-n", "--includeInverted", action="store_true")
    p.add_argument("-q", "--queryFastaFile", default=None)
    args = p.parse_args(argv)
    timer = start(args, "Paffy to_bed")
    cm = CoverageMap()
    seen_qlens: dict = {}
    for t in stream_tables(args):
        # the walk asserts fire before write_bed writes anything
        # (impl/paf.c:691-709); with -n the inverted records walk the same
        # count arrays, so their names and lengths meet the query's
        bad = query_walk_violation(t, seen_qlens)
        if bad >= 0:
            raise _walk_abort("record", t, bad)
        if args.includeInverted:
            # the reference registers each record's query array, then its
            # inverted target array, record by record: names are registered
            # in that interleaved order, so write_bed's rows come in it
            # (impl/paf_to_bed.c:173-183)
            cm.register_batch(np.column_stack([t.qname, t.tname]).ravel(),
                              np.column_stack([t.qlen, t.tlen]).ravel())
        cm.add(t)
        if args.includeInverted:
            ti = invert(t)
            bad = query_walk_violation(ti, seen_qlens)
            if bad >= 0:
                raise _walk_abort("inverted record", ti, bad)
            cm.add(ti)
    out = open_output(args)
    try:
        # each sequence's rows, the sequences in first-seen order (write_bed,
        # impl/paf_to_bed.c:33-55)
        for name in cm.names:
            starts, ends, vals = run_length_rows(cm.counts(name), args.binary)
            keep = (ends - starts) >= args.minSize
            keep &= np.where(vals == 0, not args.excludeUnaligned,
                             not args.excludeAligned)
            shown = np.where(vals > 0, 1, 0) if args.binary else vals
            rows = zip(starts[keep].tolist(), ends[keep].tolist(),
                       shown[keep].tolist())
            out.write("".join(f"{name} {s} {e} {v}\n" for s, e, v in rows))
        # FASTA records no alignment touched, as rows of count 0
        # (write_missing_fasta_seqs, impl/paf_to_bed.c:63-67,187-190)
        if args.excludeAligned and args.queryFastaFile:
            covered = set(cm.names)
            for name, seq in read_fasta(args.queryFastaFile).items():
                if name not in covered:
                    out.write(f"{name} 0 {len(seq)}\t0\n")
    finally:
        out.close()
    timer.done()
    return 0
