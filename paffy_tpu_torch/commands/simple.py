"""paffy add_mismatches and paffy trim on the port (counterpart of
paffy_tpu/commands/simple.py:387-462, ``add_mismatches_main``, and
:268-337, ``trim_main`` and ``_first_empty_cigar``).

The same flags, output bytes and exit codes as paffy_tpu's: M runs become
=/X runs (impl/paf_add_mismatches.c), and ``-a`` merges =/X runs back into
M runs.  Per batch, in the reference's per-record order: the first record
whose query or target sequence is missing ends the batch; paf_check runs
before the encode (each M op's =/X runs sum to its length, so the check's
verdict is the reference's check after the encode); the encoded records
before a failing record or a missing sequence are written before the
command fails.  The encode runs K2 and K4 on the device
(ops/mismatch.encode_mismatches) and serializes the encoded table, where
paffy_tpu fuses encode and serialize in C; the bytes are the same.

``trim`` (impl/paf_trim.c) is host code: the identity trim of
ops/tailtrim.py by default, the fixed end trim with ``-f``.
"""

from __future__ import annotations

import sys

import numpy as np

from paffy_tpu_torch import devconf, phases
from paffy_tpu_torch.commands.common import (base_parser,
                                             close_output_binary,
                                             open_output_binary, start,
                                             stream_tables, stream_transform)
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops.mismatch import SequencePool, encode_mismatches
from paffy_tpu_torch.ops.tailtrim import trim_unreliable_tails
from paffy_tpu_torch.ops.transforms import (remove_mismatches, stats_calc,
                                            trim_end_fraction)
from paffy_tpu_torch.utils.logging import log_info


def add_mismatches_main(argv) -> int:
    p = base_parser("paffy add_mismatches",
                    "Add mismatches to PAF alignments (so encoding X and = in "
                    "place of M)")
    p.add_argument("fasta_files", nargs="*")
    p.add_argument("-a", "--removeMismatches", action="store_true",
                   help="Remove mismatches, removing X and = encoding and "
                        "replacing with M")
    args = p.parse_args(argv)
    timer = start(args, "Paffy add_mismatches")
    if args.removeMismatches:
        def step(t):
            t = remove_mismatches(t)
            pafio.paf_check(t)
            return t
        stream_transform(args, step)
        timer.done()
        return 0

    devconf.device()        # no device: raise before reading any input
    with phases.timed("fasta"):
        pool = SequencePool.from_fasta_files(args.fasta_files)
    pool.ext        # upload and K2 before the first batch
    log_info("Read %d sequences from sequence files", len(pool.index))
    out = open_output_binary(args)

    def write_encoded(t):
        if len(t):
            enc = encode_mismatches(t, pool)
            with phases.timed("serialize"):
                data = pafio.serialize_paf_bytes(enc)
            with phases.timed("write"):
                out.write(data)

    tables = stream_tables(args)
    try:
        while True:
            with phases.timed("parse"):
                t = next(tables, None)
            if t is None:
                break
            if not len(t):
                continue
            bad, role, name = pool.first_missing_seq(t)
            sel = t if bad < 0 else t.take(np.arange(bad))
            try:
                pafio.paf_check(sel)
            except pafio.PafCheckError as e:
                write_encoded(sel.take(np.arange(e.record_index)))
                raise
            write_encoded(sel)
            if bad >= 0:
                raise KeyError(f"No {role} sequence named: {name} found")
    except KeyError as e:
        print(str(e.args[0]), file=sys.stderr)
        return 1
    finally:
        tables.close()
        close_output_binary(out)
    timer.done()
    return 0


def _first_empty_cigar(t) -> int:
    """The first record whose cigar has no op of any length (no cg tag,
    empty text, or all trimmed away), or -1: the records whose identity the
    reference's trim computes as 0/0 = NaN.  Indels count as mismatches
    there (impl/paf.c:818-828), so an all-I or all-D record has identity 0,
    not NaN."""
    if len(t) == 0:
        return -1
    s = stats_calc(t)
    total = (s["matches"] + s["mismatches"] + s["query_insert_bases"]
             + s["query_delete_bases"])
    z = np.flatnonzero(total == 0)
    return int(z[0]) if len(z) else -1


def trim_main(argv) -> int:
    p = base_parser("paffy trim", "Trims the ends of a PAF file")
    p.add_argument("-r", "--trimIdentity", type=float, default=0.05)
    p.add_argument("-t", "--trimFraction", type=float, default=1.0)
    p.add_argument("-f", "--fixedTrim", action="store_true")
    args = p.parse_args(argv)
    timer = start(args, "Paffy trim")

    def step(t):
        if args.fixedTrim:
            t = trim_end_fraction(t, args.trimFraction)
        else:
            t = trim_unreliable_tails(t, args.trimIdentity, args.trimFraction)
            # the reference asserts final_identity >= identity after the
            # trim (impl/paf.c:952), and NaN fails any compare: a record
            # with an op-free cigar aborts (SIGABRT: the records before it
            # are written, the sub-block stdio tail is lost).  An earlier
            # record's own paf_check failure wins, as the reference trims,
            # checks and writes record by record.
            bad = _first_empty_cigar(t)
            if bad >= 0:
                pre = t.take(np.arange(bad))
                pafio.paf_check(pre, check_raw_spans=True)
                err = pafio.PafCheckError(
                    f"trim: op-free cigar record, "
                    f"{pafio.format_record(t, bad)}",
                    table=pre, record_index=bad)
                err.stdio_lost_tail = True
                raise err
        pafio.paf_check(t, check_raw_spans=True)
        return t
    # the identity trim streams raw cigars (a kept cigar is a byte range of
    # the cg text); the fixed trim rewrites op lengths, so it parses.  The
    # reference parses and span-checks either way (impl/paf_trim.c:116-124),
    # hence the validated raw read and check_raw_spans.
    if args.fixedTrim:
        stream_transform(args, step)
    else:
        stream_transform(args, step, parse_cigars=False,
                         validate_cigars=True)
    timer.done()
    return 0
