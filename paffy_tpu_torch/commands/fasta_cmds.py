"""The faffy commands of the port: chunk, merge and extract (counterpart of
paffy_tpu/commands/fasta_cmds.py: ``chunk_main`` :28, ``merge_main`` :130,
``extract_main`` :185; the reference's impl/fasta_chunk.c,
impl/fasta_merge.c and impl/fasta_extract.c).

Host code, as in paffy_tpu: the same flags, files, output bytes and exit
codes.  chunk cuts sequences into overlapping chunks named
``name|length|start`` and lists the chunk files on stdout; merge joins such
chunks back, cutting each overlap at its midpoint; extract writes the
flank-padded, coalesced intervals of a BED file as fragments named the
same way.
"""

from __future__ import annotations

import os
import sys

from paffy_tpu_torch.commands.common import (GlibcWriter, _TextGlibcFacade,
                                             abort_writers, base_parser,
                                             open_input, open_output, start)
from paffy_tpu_torch.core.fasta import (_LEADING_INT, SequenceLineWriter,
                                        encode_header, read_fasta,
                                        read_fasta_list, write_fasta_record)
from paffy_tpu_torch.utils.logging import (CommandTimer, log_critical,
                                           log_debug, log_info,
                                           set_log_level_from_string)

_ACGTN_BYTES = b"acgtnACGTN"


def _check_acgtn(seq: str, context: str) -> None:
    """The reference's ACGTN-only check (impl/fasta_chunk.c:91-94,
    impl/fasta_extract.c:42-45), at memory speed through bytes.translate."""
    residue = seq.encode("latin-1", "replace").translate(None, _ACGTN_BYTES)
    if residue:
        bad = sorted(set(residue.decode("latin-1")))
        raise ValueError(f"non-ACGTN character(s) {bad} in {context}")


def chunk_main(argv) -> int:
    p = base_parser("faffy chunk",
                    "Breaks up a set of fasta sequences into a series of "
                    "overlapping chunks, printing the names of each chunk file "
                    "to standard out", io=False)
    p.add_argument("fasta_files", nargs="*")
    p.add_argument("-c", "--chunkSize", type=int, default=10000000)
    p.add_argument("-o", "--overlap", type=int, default=100000)
    p.add_argument("-d", "--dir", default="./temp_fastas")
    p.add_argument("--lineWidth", type=int, default=0,
                   help="Wrap FASTA sequence lines at this width (0 = one "
                        "line per sequence, the default byte format; "
                        "sonLib's fastaWrite wraps)")
    args = p.parse_args(argv)
    set_log_level_from_string(args.logLevel)
    timer = CommandTimer("Faffy chunk")
    log_info("Chunks output directory : %s", args.dir)
    log_info("Chunk size : %d", args.chunkSize)
    log_info("Chunk overlap size : %d", args.overlap)

    if os.path.exists(args.dir):
        if not os.path.isdir(args.dir):
            print(f"Output directory is not a directory: {args.dir}",
                  file=sys.stderr)
            return 1
        if os.listdir(args.dir):
            print("Output directory is not empty, please specify an empty "
                  "directory ", file=sys.stderr)
            return 1
    else:
        log_critical("Output directory does not exist, trying to create it: %s",
                     args.dir)
        os.makedirs(args.dir)

    # the chunk files and the listing on stdout both keep stdio blocks:
    # the non-ACGTN assert (SIGABRT) loses the listing's unflushed tail
    # and the open chunk's, while finished chunks were fclosed
    lst_out = (_TextGlibcFacade(GlibcWriter(sys.stdout.buffer, owns=False))
               if hasattr(sys.stdout, "buffer") else sys.stdout)
    chunk_no = 0
    chunk_fh = chunk_path = None
    chunk_remaining = args.chunkSize

    def start_chunk():
        nonlocal chunk_fh, chunk_path, chunk_no, chunk_remaining
        if chunk_fh is None:
            chunk_path = f"{args.dir}/{chunk_no}.fa"
            chunk_no += 1
            chunk_fh = _TextGlibcFacade(GlibcWriter(open(chunk_path, "wb"),
                                                    owns=True))
            chunk_remaining = args.chunkSize
            log_debug("Starting chunk %s", chunk_path)

    def finish_chunk():
        nonlocal chunk_fh, chunk_path
        if chunk_fh is not None:
            chunk_fh.close()
            log_debug("Finishing chunk %s", chunk_path)
            lst_out.write(chunk_path + "\n")
            chunk_fh = chunk_path = None

    for f in args.fasta_files:
        log_info("Chunking sequence file : %s", f)
        for header, seq in read_fasta_list(f):
            # asserted per sequence, as the reference does
            # (processSequenceToChunk, impl/fasta_chunk.c:74): an empty
            # input with degenerate sizes exits 0; chunkSize > 0 stands for
            # the reference's endless loop or crash on sizes it never meant
            assert args.chunkSize > args.overlap
            assert args.chunkSize > 0
            n = len(seq)
            # fixed stride, each chunk reaching past it by the overlap
            # (impl/fasta_chunk.c:72-104)
            for i in range(0, n, args.chunkSize):
                start_chunk()
                j = min(i + args.chunkSize + args.overlap, n)
                piece = seq[i:j]
                try:
                    _check_acgtn(piece, f"chunk of {header}")
                except ValueError as e:
                    # a per-base assert: SIGABRT, the unflushed tails are
                    # lost (impl/fasta_chunk.c:93-97)
                    e.stdio_lost_tail = True
                    raise
                write_fasta_record(chunk_fh, encode_header(header, n, i),
                                   piece, args.lineWidth)
                chunk_remaining -= j - i
                if chunk_remaining <= 0:
                    finish_chunk()
    finish_chunk()
    if lst_out is not sys.stdout:
        lst_out.close()
    timer.done()
    return 0


def merge_main(argv) -> int:
    p = base_parser("faffy merge",
                    "Merges a series of fasta files, which may contain "
                    "overlapping sequences, into a single fasta file")
    p.add_argument("--lineWidth", type=int, default=0,
                   help="Wrap FASTA sequence lines at this width (0 = one "
                        "line per overlap piece, the default byte format)")
    args = p.parse_args(argv)
    timer = start(args, "Faffy merge")
    inp = open_input(args)
    out = open_output(args)
    writer = SequenceLineWriter(out, args.lineWidth)
    # the pending sequence (it may overlap the next chunk) and its start in
    # the whole sequence (impl/fasta_merge.c:34-86)
    p_coord = 0
    p_seq = None
    try:
        for line in inp:
            for path in line.split():
                for header, seq in read_fasta_list(path):
                    parts = header.split("|")
                    offset = int(parts[-1])
                    assert offset >= 0
                    if offset == 0:
                        if p_seq is not None:
                            writer.piece(p_seq)
                        writer.end()
                        # the header without its |length|start fields
                        out.write(">" + "|".join(parts[:-2]) + "\n")
                        p_coord = 0
                        p_seq = seq
                    else:
                        assert p_seq is not None
                        seq_len = len(p_seq)
                        assert p_coord + seq_len >= offset  # overlap or abut
                        # cut the overlap at its midpoint
                        # (impl/fasta_merge.c:69)
                        split_point = (p_coord + seq_len + offset) // 2
                        log_debug("Merging at a split point: %d", split_point)
                        writer.piece(p_seq[: split_point - p_coord])
                        p_seq = seq[split_point - offset:]
                        p_coord = split_point
        if p_seq is not None:
            writer.piece(p_seq)
        writer.end()
    finally:
        if inp is not sys.stdin:
            inp.close()
        out.close()
    timer.done()
    return 0


def _atol(s: str) -> int:
    """C atol: an optional sign and the leading digits, 0 without digits
    (the reference reads BED fields with atol, impl/fasta_extract.c:180)."""
    m = _LEADING_INT.match(s)
    return int(m.group()) if m else 0


def extract_main(argv) -> int:
    p = base_parser("faffy extract",
                    "Extracts subsequences from a fasta file according to "
                    "intervals in a bed file", io=False)
    p.add_argument("fasta_files", nargs="*")
    p.add_argument("-i", "--bedFile", default=None)
    p.add_argument("-o", "--outputFile", default=None)
    p.add_argument("-f", "--flank", type=int, default=10)
    p.add_argument("-m", "--minSize", type=int, default=100)
    p.add_argument("-n", "--skipMissing", action="store_true")
    p.add_argument("--lineWidth", type=int, default=0,
                   help="Wrap FASTA sequence lines at this width (0 = one "
                        "line per sequence, the default byte format)")
    args = p.parse_args(argv)
    set_log_level_from_string(args.logLevel)
    timer = CommandTimer("Faffy extract")
    log_info("Bed file : %s", args.bedFile)
    log_info("Flank size : %d", args.flank)
    log_info("Minimum sequence size (minSize) : %d", args.minSize)

    seqs = {}
    for f in args.fasta_files:
        seqs.update(read_fasta(f))
    log_info("Read %d sequences from sequence files", len(seqs))

    inp = sys.stdin if args.bedFile is None else open(args.bedFile, "r")
    out = open_output(args)
    try:
        intervals = []
        for line in inp:
            tok = line.split()
            if not tok:
                continue
            name, s, e = tok[0], _atol(tok[1]), _atol(tok[2])
            if name not in seqs:
                if args.skipMissing:
                    continue
                print(f"Missing sequence: {name}", file=sys.stderr)
                return 1
            intervals.append((name, s, e))
        intervals.sort()   # by (name, start, end), as interval_cmp

        def report(name, s, e):
            seq = seqs[name]
            piece = seq[s:e]
            _check_acgtn(piece, f"extract of {name}")
            write_fasta_record(out, encode_header(name, len(seq), s), piece,
                               args.lineWidth)

        # flanks added, then overlapping or adjacent intervals coalesced
        # (impl/fasta_extract.c:199-233)
        prev = None   # (name, start, end)
        for name, s, e in intervals:
            if e - s < args.minSize:
                continue
            seq_len = len(seqs[name])
            i = max(s - args.flank, 0)
            j = min(e + args.flank, seq_len)
            if s < 0 or s > e or e > seq_len:
                # the reference's interval asserts
                # (impl/fasta_extract.c:211): SIGABRT, the pending interval
                # is never written and only full stdio blocks reached the
                # output
                abort_writers()
                print(f"extract: interval {name}:{s}-{e} out of bounds "
                      f"(sequence length {seq_len})", file=sys.stderr)
                return 1
            if prev is not None:
                if prev[0] == name and prev[2] >= i:
                    prev = (name, prev[1], max(prev[2], j))
                    continue
                report(*prev)
            prev = (name, i, j)
        if prev is not None:
            report(*prev)
    finally:
        if inp is not sys.stdin:
            inp.close()
        out.close()
    timer.done()
    return 0
