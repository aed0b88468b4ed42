"""paffy tile on the port (counterpart of
paffy_tpu/commands/chain_tile_bed.py:46-68, ``tile_main``; the reference's
impl/paf_tile.c).  chain and to_bed are not ported yet.

The same output bytes and exit codes as paffy_tpu's: the whole input is
read, the reference's coverage-walk asserts are checked before anything is
written (an assert loses the stdio tail, as the reference's abort does),
and the records are written best-first with their tile levels (tl tag),
which K5 computes on the device (ops/tile.py).
"""

from __future__ import annotations

from dataclasses import replace

from paffy_tpu_torch import devconf, phases
from paffy_tpu_torch.commands.common import (base_parser, read_table, start,
                                             write_table)
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops.tile import assign_tile_levels, tile_sort_order
from paffy_tpu_torch.ops.transforms import query_walk_violation


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
