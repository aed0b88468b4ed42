"""The streaming per-record commands of the port: add_mismatches, trim,
invert, shatter, dedupe and filter (counterpart of
paffy_tpu/commands/simple.py; the reference's impl/paf_add_mismatches.c,
impl/paf_trim.c, impl/paf_invert.c, impl/paf_shatter.c, impl/paf_dedupe.c
and impl/paf_filter.c).

The same flags, output bytes and exit codes as paffy_tpu's, and the same
records written before a failure.  ``add_mismatches`` (:387-462): M runs
become =/X runs, and ``-a`` merges =/X runs back into M runs.  Per batch,
in the reference's per-record order: the first record whose query or
target sequence is missing ends the batch; paf_check runs before the
encode (each M op's =/X runs sum to its length, so the check's verdict is
the reference's check after the encode); the encoded records before a
failing record or a missing sequence are written before the command fails.
The encode runs K2 and K4 on the device (ops/mismatch.encode_mismatches)
and serializes the encoded table, where paffy_tpu fuses encode and
serialize in C; the bytes are the same.

The others are host code, as in paffy_tpu, and never touch the device:
``trim`` (:268-337) the identity trim of ops/tailtrim.py by default, the
fixed end trim with ``-f``; ``invert`` (:25) and ``shatter`` (:73) their
fused native serializers; ``dedupe`` (:120, ``DedupeState`` :159) and
``filter`` (:340) vectorized over each batch.
"""

from __future__ import annotations

import sys

import numpy as np

from paffy_tpu_torch import native, phases
from paffy_tpu_torch.commands.common import (base_parser,
                                             close_output_binary,
                                             open_output_binary, start,
                                             stream_tables, stream_transform,
                                             write_check_prefix)
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.ops.tailtrim import trim_unreliable_tails
from paffy_tpu_torch.ops.transforms import (invert, remove_mismatches,
                                            shatter_violation, stats_calc,
                                            trim_end_fraction)
from paffy_tpu_torch.utils.logging import debug_enabled, log_debug, log_info


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

    # the device modules load torch: the host commands of this module never
    # import them
    from paffy_tpu_torch import devconf
    from paffy_tpu_torch.ops.mismatch import SequencePool, encode_mismatches
    devconf.device()        # no device: raise before reading any input
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


def invert_main(argv) -> int:
    p = base_parser("paffy invert", "Inverts the query and target in a PAF file")
    args = p.parse_args(argv)
    timer = start(args, "Paf invert")
    out = open_output_binary(args)
    try:
        # raw cigars: the fused serializer rewrites the cg text token by
        # token, checking the spans as it goes, and paf_check on the raw
        # table checks the bounds (together the reference's paf_check after
        # the invert, which is symmetric in query and target).  A batch
        # with a non-canonical cigar arrives parsed and takes invert().
        for t in stream_tables(args, parse_cigars=False,
                               validate_cigars=True):
            if not len(t):
                continue
            if t.raw_cg is not None:
                try:
                    pafio.paf_check(t)
                except pafio.PafCheckError as e:
                    # the reference inverts, checks and writes record by
                    # record: the inverted records before the bad one
                    if e.record_index:
                        native.invert_serialize(
                            t.take(np.arange(e.record_index)), fh=out)
                    raise
                native.invert_serialize(t, fh=out)
                continue
            try:
                t = invert(t)
                pafio.paf_check(t)
            except pafio.PafCheckError as e:
                write_check_prefix(out, e)
                raise
            out.write(pafio.serialize_paf_bytes(t))
    finally:
        close_output_binary(out)
    timer.done()
    return 0


def shatter_main(argv) -> int:
    p = base_parser("paffy shatter", "Break up paf alignments into individual matches")
    args = p.parse_args(argv)
    timer = start(args, "Paffy shatter")
    out = open_output_binary(args)
    try:
        for t in stream_tables(args):
            if not len(t):
                continue
            # the reference's walk asserts per op and per record, and
            # paf_checks each shard it builds (impl/paf.c:600-663).  Both
            # deaths come after the shards of the records before the bad
            # one were written; an assert ("abort", SIGABRT) loses the
            # sub-block stdio tail, a shard check ("check", st_errAbort)
            # flushes it.
            kind, rec = shatter_violation(t)
            if kind is not None:
                if rec > 0:
                    native.shatter_serialize(t.take(np.arange(rec)), fh=out)
                err = pafio.PafCheckError(
                    f"shatter: invalid record, {pafio.format_record(t, rec)}")
                err.stdio_lost_tail = kind == "abort"
                raise err
            native.shatter_serialize(t, fh=out)
    finally:
        close_output_binary(out)
    timer.done()
    return 0


def dedupe_main(argv) -> int:
    p = base_parser("paffy dedupe", "Remove duplicate paf records")
    p.add_argument("-a", "--checkInverse", action="store_true",
                   help="Also deduplicate alignments that are the same, but "
                        "with query and target reversed")
    args = p.parse_args(argv)
    timer = start(args, "Paffy dedupe")
    state = DedupeState(args.checkInverse)

    def step(t):
        keep, checked = state.process(t)
        if checked is not None and checked.any():
            # -a: the reference paf_checks exactly the records whose direct
            # probe of the kept hash missed (impl/paf_dedupe.c:120-124), on
            # unparsed cigars, so the spans are never checked
            try:
                pafio.paf_check(t, idx=np.flatnonzero(checked))
            except pafio.PafCheckError as e:
                # the kept records before the bad one were written
                pre = t.take(keep & (np.arange(len(t)) < e.record_index))
                e.table, e.record_index = pre, len(pre)
                raise
        if debug_enabled():
            for i in np.flatnonzero(~keep):
                log_debug("Got duplicate pafs:")
                log_debug("\t\tdupe (1) - : %s", pafio.format_record(t, i))
        return t.take(keep)
    # raw cigars, unvalidated: the reference reads with parse_cigar=0
    # (impl/paf_dedupe.c:117), so any cg text passes through as it is
    stream_transform(args, step, parse_cigars=False)
    timer.done()
    return 0


class DedupeState:
    """First-occurrence-wins dedupe on the full coordinate key
    (impl/paf_dedupe.c:27-46,117-143), vectorized over a batch and carried
    across batches.

    With ``check_inverse`` a record is also a duplicate when its key with
    query and target swapped was seen before.  The reference probes its
    hash of kept records; probing every earlier key gives the same
    decisions (a record dropped by a direct hit repeats a kept key, one
    dropped by an inverse hit shares its inverse with a kept key).
    """

    def __init__(self, check_inverse: bool):
        self.check_inverse = check_inverse
        self.name_id: dict[str, int] = {}
        self.seen = None    # the sorted keys kept so far, all batches

    def _probe_seen(self, keys) -> np.ndarray:
        if self.seen is None or len(self.seen) == 0:
            return np.zeros(len(keys), dtype=bool)
        pos = np.clip(np.searchsorted(self.seen, keys), 0, len(self.seen) - 1)
        return self.seen[pos] == keys

    def process(self, t):
        """(keep, checked): keep marks the records that are not duplicates;
        checked, under check_inverse (else None), the records the reference
        paf_checks (the direct probe of its kept hash missed)."""
        n = len(t)
        if n == 0:
            return np.zeros(0, dtype=bool), None
        # names to ids through one unique pass: only distinct names touch
        # the dict, which keeps the ids stable across batches
        both = np.concatenate([t.qname, t.tname])
        uniq_names, inv = np.unique(both, return_inverse=True)
        gids = np.fromiter((self.name_id.setdefault(nm, len(self.name_id))
                            for nm in uniq_names),
                           dtype=np.int64, count=len(uniq_names))
        ids = gids[inv]
        qid, tid = ids[:n], ids[n:]

        def as_void(cols):
            keys = np.ascontiguousarray(np.stack(cols, axis=1))
            return keys.view([("", keys.dtype)] * keys.shape[1]).reshape(-1)

        strand = t.strand.astype(np.int64)
        void = as_void([qid, tid, strand, t.qstart, t.qend, t.tstart, t.tend])
        uniq, inv = np.unique(void, return_inverse=True)
        first = np.full(len(uniq), n, dtype=np.int64)
        np.minimum.at(first, inv, np.arange(n))
        dup = first[inv] < np.arange(n)
        if self.check_inverse:
            ivoid = as_void([tid, qid, strand, t.tstart, t.tend,
                             t.qstart, t.qend])
            pos = np.clip(np.searchsorted(uniq, ivoid), 0, len(uniq) - 1)
            dup |= (uniq[pos] == ivoid) & (first[pos] < np.arange(n))
            dup |= self._probe_seen(ivoid)
        seen_direct = self._probe_seen(void)
        dup |= seen_direct
        checked = None
        if self.check_inverse:
            # checked unless an earlier KEPT record has the same key (an
            # earlier twin dropped by an inverse hit is not in the hash)
            f = first[inv]
            checked = ~(seen_direct | ((f < np.arange(n)) & ~dup[f]))
        new = np.sort(void[~dup])
        if self.seen is None:
            self.seen = new
        else:
            # merge the batch's sorted keys into the sorted set
            self.seen = np.insert(self.seen, np.searchsorted(self.seen, new),
                                  new)
        return ~dup, checked


def filter_main(argv) -> int:
    p = base_parser("paffy filter", "Filter pafs based on alignment stats")
    p.add_argument("-s", "--minChainScore", type=int, default=-1)
    p.add_argument("-t", "--minAlignmentScore", type=int, default=-1)
    p.add_argument("-u", "--minIdentity", type=float, default=-1.0)
    p.add_argument("-v", "--minIdentityWithGaps", type=float, default=-1.0)
    p.add_argument("-w", "--maxTileLevel", type=int, default=-1)
    p.add_argument("-x", "--invert", action="store_true",
                   help="Only output alignments that don't pass filters")
    args = p.parse_args(argv)
    timer = start(args, "Paffy filter")

    def step(t):
        s = stats_calc(t)
        m, x = s["matches"], s["mismatches"]
        with np.errstate(invalid="ignore", divide="ignore"):
            ident = m.astype(np.float32) / (m + x).astype(np.float32)
            identg = (m.astype(np.float32)
                      / (m + x + s["query_insert_bases"]
                         + s["query_delete_bases"]).astype(np.float32))
        # the keep condition of impl/paf_filter.c:131-133; a NaN identity
        # fails >= as in C
        passes = ((t.score >= args.minAlignmentScore)
                  & (t.chain_score >= args.minChainScore)
                  & ((args.maxTileLevel == -1)
                     | (t.tile_level <= args.maxTileLevel))
                  & (ident >= np.float32(args.minIdentity))
                  & (identg >= np.float32(args.minIdentityWithGaps)))
        keep = ~passes if args.invert else passes
        if debug_enabled():
            for i in np.flatnonzero(~keep):
                log_debug("Filtering alignment with matches:%d, identity: %f "
                          "(%f with gaps), score: %d, chain-score:%d",
                          int(m[i]), float(ident[i]), float(identg[i]),
                          int(t.score[i]), int(t.chain_score[i]))
                sys.stderr.write(pafio.format_record(t, i) + "\n")
        return t.take(keep)
    # validated raw cigars: the reference parses its cigars
    # (impl/paf_filter.c:123) only to sum them, and writes kept records
    # whole, so the stats come from the cg text and the records pass
    # through as they are; the validation keeps the parse's rejections
    stream_transform(args, step, parse_cigars=False, validate_cigars=True)
    timer.done()
    return 0
