"""paffy view on the port (counterpart of paffy_tpu/commands/view.py).

The same command, flags and output bytes as paffy_tpu's: per-record stat
lines, the optional 3-row base-level alignment (impl/paf.c:282-314), and the
aggregate line with the -u/-v thresholds (impl/paf_view.c:186-197).  The
per-record column counts come from K1 and K2 on the device
(ops/mismatch.py); the rest is host code.

As in paffy_tpu, totals are accumulated without -s too, so -u/-v work
alone (the reference compares against 0/0 there and trips its assert).
"""

from __future__ import annotations

import sys

import numpy as np

from paffy_tpu_torch import devconf, native, phases
from paffy_tpu_torch.commands.common import (abort_writers, base_parser,
                                             open_output, start,
                                             stream_tables)
from paffy_tpu_torch.ops.mismatch import SequencePool, column_match_counts
from paffy_tpu_torch.ops.transforms import STAT_KEYS, stats_calc_with_m
from paffy_tpu_torch.utils.logging import log_info


def _f(x: float) -> str:
    """C printf %f of a float value (6 decimals).  NaN keeps its sign bit:
    0.0f/0.0f yields -nan on x86 and glibc prints the sign, so the
    reference emits "-nan" for empty-match identities."""
    v = float(x)
    if v != v:
        return "-nan" if np.signbit(x) else "nan"
    return f"{v:.6f}"


def _ident(matches, mismatches):
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.float32(matches) / np.float32(matches + mismatches)


def _ident_gaps(matches, mismatches, qib, qdb):
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.float32(matches) / np.float32(matches + mismatches + qib + qdb)


def _render_sliced(t, pool, blob, stats, out, max_bytes=64 << 20):
    """Stream the -a rendering in slices of about ``max_bytes`` of output:
    bounded memory (the whole batch's rendering is ~3 bytes per cigar
    column), and each slice's uint8 array goes to the writer as a
    memoryview."""
    n = len(t)
    nl = np.flatnonzero(np.frombuffer(blob, dtype=np.uint8) == ord("\n"))
    line_off = np.concatenate([[0], nl + 1])
    # per-record size: stat line + 3 bytes a column + 3 newlines a
    # 150-column window (native.view_render_batch's size model)
    ncols = (stats["matches"] + stats["mismatches"]
             + stats["query_insert_bases"] + stats["query_delete_bases"])
    sizes = np.diff(line_off) + 3 * ncols + 3 * ((ncols + 149) // 150)
    cum = np.cumsum(sizes)
    a = 0
    while a < n:
        base = int(cum[a - 1]) if a else 0
        b = int(np.searchsorted(cum, base + max_bytes, side="right"))
        b = min(max(b, a + 1), n)
        sl = t.take(np.arange(a, b))
        sub = blob[int(line_off[a]): int(line_off[b])]
        out.write_bytes(memoryview(native.view_render_batch(sl, pool, sub)))
        a = b


def main(argv) -> int:
    p = base_parser("paffy view", "Pretty print PAF alignments")
    p.add_argument("fasta_files", nargs="*")
    p.add_argument("-a", "--includeAlignment", action="store_true",
                   help="Include base level alignment in output")
    p.add_argument("-s", "--printAggregateStats", action="store_true",
                   help="Print overall stats about the alignments at the end")
    p.add_argument("-t", "--noPerAlignmentStats", action="store_true",
                   help="Do not print stats about each paf")
    p.add_argument("-u", "--errorIfIdentityLowerThanX", type=float, default=0.0)
    p.add_argument("-v", "--errorIfAlignedBasesLowerThanX", type=int, default=0)
    args = p.parse_args(argv)
    timer = start(args, "Paffy view")
    devconf.device()        # no device: raise before reading any input

    if not args.fasta_files:
        print("Expected at least one sequence file", file=sys.stderr)
        return 1
    with phases.timed("fasta"):
        pool = SequencePool.from_fasta_files(args.fasta_files)
    pool.ext        # upload and K2 before the first batch
    log_info("Read %d sequences from sequence files", len(pool.index))
    out = open_output(args)
    totals = np.zeros(6, dtype=np.int64)  # STAT_KEYS
    n_total = 0
    tables = stream_tables(args)
    try:
        while True:
            with phases.timed("parse"):
                t = next(tables, None)
            if t is None:
                break
            # a missing sequence aborts mid-stream with the records before
            # it printed (the reference fetches per record,
            # impl/paf_view.c:127-140)
            bad, role, name = pool.first_missing_seq(t)
            if bad >= 0:
                t = t.take(np.arange(bad))
            try:
                m_cols, x_cols = column_match_counts(t, pool)
            except KeyError as e:
                print(str(e.args[0]), file=sys.stderr)
                return 1
            with phases.timed("format"):
                # the stats of the reference's =/X re-encode, without
                # building the re-encoded cigar (impl/paf_view.c:167-178)
                stats, m_op_lens = stats_calc_with_m(t)
                stats["matches"] = stats["matches"] - m_op_lens + m_cols
                stats["mismatches"] = stats["mismatches"] + x_cols
                if not args.noPerAlignmentStats:
                    vals = np.column_stack([
                        t.qstart, t.qend, t.tstart, t.tend,
                        t.strand.astype(np.int64), t.score,
                        *(stats[k] for k in STAT_KEYS)])
                    blob = native.view_stats_lines(t.qname, t.tname, vals)
                    if args.includeAlignment:
                        _render_sliced(t, pool, blob, stats, out)
                    else:
                        out.write_bytes(blob)
                totals += np.array([stats[k].sum() for k in STAT_KEYS])
                n_total += len(t)
            if bad >= 0:
                # errAbort: the prefix above flushes on the clean close
                print(f"No {role} sequence named: {name} found",
                      file=sys.stderr)
                return 1
        tm, tx, tqi, tqd, tqib, tqdb = (int(v) for v in totals)
        if args.printAggregateStats:
            out.write(
                f"Total-alignments:{n_total}\tAvg-Identity:{_f(_ident(tm, tx))}"
                f"\tAvg-Identity-with-gaps:{_f(_ident_gaps(tm, tx, tqib, tqdb))}"
                f"\tAligned-bases:{tm+tx}\tAligned-bases-with-gaps:{tm+tx+tqib+tqdb}"
                f"\tQuery-inserts:{tqi}\tQuery-deletes:{tqd}\n")
        # -u/-v: float32 comparison as the reference's C float; the asserts
        # fire after the aggregate line is printed but before stdio flushes
        # it, so a failing one loses the staged tail (abort_writers)
        ident = _ident(tm, tx)
        if not (ident >= np.float32(args.errorIfIdentityLowerThanX)):
            abort_writers()
            print(f"Aggregate identity {ident} below threshold "
                  f"{args.errorIfIdentityLowerThanX}", file=sys.stderr)
            return 1
        if not (tm + tx >= args.errorIfAlignedBasesLowerThanX):
            abort_writers()
            print(f"Aligned bases {tm+tx} below threshold "
                  f"{args.errorIfAlignedBasesLowerThanX}", file=sys.stderr)
            return 1
    finally:
        tables.close()
        out.close()
    timer.done()
    return 0
