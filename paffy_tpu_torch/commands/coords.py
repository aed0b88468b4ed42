"""The coordinate commands of the port: dechunk, upconvert and split_file
(counterpart of paffy_tpu/commands/coords.py: ``dechunk_main`` :40,
``upconvert_main`` :123, ``split_file_main`` :175; the reference's
impl/paf_dechunk.c, impl/paf_upconvert.c and impl/paf_split_file.c).

Host code, as in paffy_tpu: the same flags, output bytes, files and exit
codes.  Chunked sequence names carry their origin as ``name|length|start``
(faffy chunk and faffy extract write them): dechunk turns such names and
their coordinates back into the whole sequence's, and upconvert turns a
record on a whole sequence into one on the extracted fragment that holds
it.  split_file writes each contig's records to a file of its own, and
bin-packs contigs shorter than ``-m`` into shared files.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from paffy_tpu_torch import native
from paffy_tpu_torch.commands.common import (GlibcWriter, base_parser,
                                             close_output_binary,
                                             open_output_binary, start,
                                             stream_tables,
                                             write_check_prefix)
from paffy_tpu_torch.core import pafio
from paffy_tpu_torch.core.fasta import decode_header
from paffy_tpu_torch.core.model import _as_obj_array
from paffy_tpu_torch.utils.logging import log_info


def _dechunk_side(names, starts, ends, lengths):
    """One side's ``name|length|start`` names decoded and its coordinates
    shifted by the start (convertCoordinatesP, impl/paf_dechunk.c:24-38);
    each distinct name is decoded once."""
    uniq, inv = np.unique(names, return_inverse=True)
    ivs = [decode_header(nm) for nm in uniq]
    shift = np.array([iv.start for iv in ivs], dtype=np.int64)[inv]
    return (_as_obj_array([iv.name for iv in ivs])[inv], starts + shift,
            ends + shift, np.array([iv.length for iv in ivs],
                                   dtype=np.int64)[inv])


def dechunk_main(argv) -> int:
    p = base_parser("paffy dechunk",
                    "Modifies paf coordinates to remove the chunk coordinate "
                    "name encoding created by fasta_chunk")
    p.add_argument("-q", "--query", action="store_true",
                   help="only fix the query side")
    p.add_argument("-t", "--target", action="store_true",
                   help="only fix the target side")
    args = p.parse_args(argv)
    timer = start(args, "Paffy dechunk")
    # -t fixes the target side only, -q the query side only
    # (impl/paf_dechunk.c:81-86)
    fix_query = not args.target
    fix_target = not args.query
    out = open_output_binary(args)
    try:
        # validated raw cigars: the reference parses its cigars
        # (impl/paf_dechunk.c:114) but never rewrites them, and its
        # paf_check checks their spans, hence check_raw_spans
        for t in stream_tables(args, parse_cigars=False,
                               validate_cigars=True):
            if fix_query:
                qn, qs, qe, ql = _dechunk_side(t.qname, t.qstart, t.qend,
                                               t.qlen)
                t = replace(t, qname=qn, qstart=qs, qend=qe, qlen=ql)
            if fix_target:
                tn, ts, te, tl = _dechunk_side(t.tname, t.tstart, t.tend,
                                               t.tlen)
                t = replace(t, tname=tn, tstart=ts, tend=te, tlen=tl)
            try:
                pafio.paf_check(t, check_raw_spans=True)
            except pafio.PafCheckError as e:
                write_check_prefix(out, e)
                raise
            out.write(pafio.serialize_paf_bytes(t))
    finally:
        close_output_binary(out)
    timer.done()
    return 0


def _upconvert_side(intervals, names, starts, ends, lengths):
    """One side's coordinates moved onto the extracted fragment that holds
    them (fix_interval, impl/paf_upconvert.c:52-69): a record whose start
    lies in a fragment ([start, end], ends inclusive) is renamed to the
    fragment's ``name|length|start``; one that starts in a fragment and
    ends past it raises; one in no fragment stays as it is.  One
    searchsorted per distinct name."""
    new_names = np.array(names, dtype=object)
    new_starts = starts.copy()
    new_ends = ends.copy()
    new_lens = lengths.copy()
    uniq, inv = np.unique(names, return_inverse=True)
    for u_i, nm in enumerate(uniq):
        frags = intervals.get(nm)
        if not frags:
            continue
        sel = np.flatnonzero(inv == u_i)
        fs = np.array([f[0] for f in frags], dtype=np.int64)
        fe = np.array([f[1] for f in frags], dtype=np.int64)
        fl = np.array([f[2] for f in frags], dtype=np.int64)
        k = np.searchsorted(fs, starts[sel], side="right") - 1
        kc = np.clip(k, 0, len(fs) - 1)
        ok = (k >= 0) & (starts[sel] <= fe[kc])
        cross = np.flatnonzero(ok & (ends[sel] > fe[kc]))
        if len(cross):
            i, ki = int(sel[cross[0]]), int(kc[cross[0]])
            raise pafio.PafCheckError(
                f"alignment crosses extracted-fragment boundary: {nm} "
                f"[{starts[i]},{ends[i]}) vs fragment "
                f"[{int(fs[ki])},{int(fe[ki])})")
        fragnames = np.array([f"{nm}|{ln}|{s}" for s, _, ln in frags],
                             dtype=object)
        app, kf = sel[ok], kc[ok]
        new_names[app] = fragnames[kf]
        new_starts[app] = starts[app] - fs[kf]
        new_ends[app] = ends[app] - fs[kf]
        new_lens[app] = fl[kf]
    return new_names, new_starts, new_ends, new_lens


def upconvert_main(argv) -> int:
    p = base_parser("paffy upconvert",
                    "Converts the coordinates of paf alignments to refer to "
                    "extracted subsequences")
    p.add_argument("fasta_files", nargs="*")
    args = p.parse_args(argv)
    timer = start(args, "Paf upconvert")
    # the fragments, from the extracted FASTA's headers
    # (fastaRead_readCoordinates, impl/paf_upconvert.c:27-33): end = start
    # + the fragment's own length, length = the whole sequence's; only
    # headers and sequence lengths are read
    intervals: dict[str, list[tuple[int, int, int]]] = {}
    for f in args.fasta_files:
        with open(f, "rb") as fh:
            recs = native.fasta_headers(fh.read())
        for header, seq_len in recs:
            iv = decode_header(header)
            intervals.setdefault(iv.name, []).append(
                (iv.start, iv.start + seq_len, iv.length))
    for v in intervals.values():
        v.sort()
    out = open_output_binary(args)
    try:
        # raw cigars, unvalidated: the reference reads with parse_cigar=0
        # and its paf_check skips the spans of unparsed cigars
        # (impl/paf_upconvert.c:148, impl/paf.c:427-461)
        for t in stream_tables(args, parse_cigars=False):
            qn, qs, qe, ql = _upconvert_side(intervals, t.qname, t.qstart,
                                             t.qend, t.qlen)
            tn, ts, te, tl = _upconvert_side(intervals, t.tname, t.tstart,
                                             t.tend, t.tlen)
            t = replace(t, qname=qn, qstart=qs, qend=qe, qlen=ql,
                        tname=tn, tstart=ts, tend=te, tlen=tl)
            try:
                pafio.paf_check(t)
            except pafio.PafCheckError as e:
                write_check_prefix(out, e)
                raise
            out.write(pafio.serialize_paf_bytes(t))
    finally:
        close_output_binary(out)
    timer.done()
    return 0


def split_file_main(argv) -> int:
    p = base_parser("paffy split_file",
                    "Split PAF file into separate output files by target "
                    "(default) or query contig name", io=False)
    p.add_argument("-i", "--inputFile", default=None)
    p.add_argument("-p", "--prefix", default="split_")
    p.add_argument("-q", "--query", action="store_true",
                   help="Split by query contig name instead of target")
    p.add_argument("-m", "--minLength", type=int, default=0,
                   help="Small contigs are bin-packed into combined files")
    args = p.parse_args(argv)
    timer = start(args, "Paffy split_file")
    # first-fit sequential bin packing of the contigs shorter than
    # minLength (impl/paf_split_file.c:142-169): a new small file opens
    # when the current one's contig lengths would pass minLength; a
    # contig's records all go to one file.  Files stay open across batches.
    handles: dict[str, GlibcWriter] = {}
    contig_file: dict[str, str] = {}
    small_idx, small_total, small_path = 0, 0, None
    total = 0
    try:
        # raw cigars, unvalidated: the reference reads with parse_cigar=0
        # (impl/paf_split_file.c:142) and never looks at the cg text
        for t in stream_tables(args, parse_cigars=False):
            total += len(t)
            names = t.qname if args.query else t.tname
            lengths = t.qlen if args.query else t.tlen
            by_file: dict[str, list[int]] = {}    # in first-record order
            for i in range(len(t)):
                nm = names[i]
                path = contig_file.get(nm)
                if path is None:
                    ln = int(lengths[i])
                    if 0 < args.minLength and ln < args.minLength:
                        if (small_path is None
                                or small_total + ln > args.minLength):
                            small_path = (f"{args.prefix}small_"
                                          f"{small_idx}.paf")
                            small_idx += 1
                            small_total = 0
                            log_info("Opened small contigs output file: %s",
                                     small_path)
                        small_total += ln
                        path = small_path
                    else:
                        path = f"{args.prefix}{nm.replace('/', '_')}.paf"
                        log_info("Opened output file: %s", path)
                    contig_file[nm] = path
                by_file.setdefault(path, []).append(i)
            for path, rows in by_file.items():
                fh = handles.get(path)
                if fh is None:
                    # each file has its own stdio blocks, as the
                    # reference's FILE* per contig; the CLI ends every
                    # open one by the error's class
                    fh = handles[path] = GlibcWriter(open(path, "wb"),
                                                     owns=True)
                fh.write(pafio.serialize_paf_bytes(
                    t.take(np.array(rows, dtype=np.int64))))
    finally:
        for fh in handles.values():
            fh.close()
    log_info("Split %d records", total)
    timer.done()
    return 0
