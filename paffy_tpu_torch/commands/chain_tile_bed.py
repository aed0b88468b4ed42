"""paffy chain and paffy tile on the port (counterpart of
paffy_tpu/commands/chain_tile_bed.py:21-68, ``chain_main`` and
``tile_main``; the reference's impl/paf_chain.c and impl/paf_tile.c).
to_bed is not ported yet.

The same output bytes and exit codes as paffy_tpu's.  chain reads the
cigars raw (it writes them back as they were), tags the records with their
chains (cn, s1) in input order, K6 running the DP on the device
(ops/chain.py), and writes them by descending score.  tile reads the whole
input, checks the reference's coverage-walk asserts before anything is
written (an assert loses the stdio tail, as the reference's abort does),
and writes the records best-first with their tile levels (tl tag), which
K5 computes on the device (ops/tile.py).
"""

from __future__ import annotations

from dataclasses import replace

from paffy_tpu_torch import devconf, phases
from paffy_tpu_torch.commands.common import (base_parser, read_table, start,
                                             write_table)
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops.chain import paf_chain_order
from paffy_tpu_torch.ops.tile import assign_tile_levels, tile_sort_order
from paffy_tpu_torch.ops.transforms import query_walk_violation
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
