"""PAF text <-> PafTable, and the paf_check sweep (counterpart of
paffy_tpu/core/pafio.py: parse, ``parse_cigar_string`` :43,
``serialize_paf`` :285, ``serialize_paf_bytes``, ``read_paf_file`` :315,
``write_paf_file`` :322, ``format_record``, ``paf_check`` :344-383).

The behavioural contract is the reference parser (impl/paf.c:137-209: tab
tokenizer, strand validation, tag dispatch on the two-character code,
unknown tags dropped; cigars of M/I/D/=/X only, impl/paf.c:70-111) and
paf_check (impl/paf.c:427-461), both in the native library.
"""

from __future__ import annotations

import re

import numpy as np

from paffy_tpu_torch import native
from paffy_tpu_torch.core.model import (CHAR_TO_OP, INT_MAX, OP_TO_CHAR,
                                        PafTable)

_CHECK_MESSAGES = ("Paf query start coordinates are invalid",
                   "Paf query end coordinates are invalid",
                   "Paf target start coordinates are invalid",
                   "Paf target end coordinates are invalid",
                   "Paf cigar alignment does not match query length",
                   "Paf cigar alignment does not match target length")


class PafFormatError(ValueError):
    """Malformed PAF input.  ``line_no`` (when known) is the 1-based line
    number within the data passed to the failing parse call, so a streaming
    caller can emit the records before it."""

    def __init__(self, msg, line_no=None):
        super().__init__(msg)
        self.line_no = line_no


_CIGAR_RE = re.compile(r"(\d+)([MIDX=])")


def parse_cigar_string(s: str) -> list[tuple[int, int]]:
    """A cigar string as [(op, length)]; an empty string gives [] (no
    cigar, as cigar_parse returns NULL, impl/paf.c:71-73).  Any other
    character raises PafFormatError."""
    if not s:
        return []
    out = []
    pos = 0
    for m in _CIGAR_RE.finditer(s):
        if m.start() != pos:
            break
        out.append((CHAR_TO_OP[m.group(2)], int(m.group(1))))
        pos = m.end()
    if pos != len(s):
        raise PafFormatError(f"Got an unexpected character in paf cigar "
                             f"string: {s[pos]!r}")
    return out


def parse_paf_text(text: str) -> PafTable:
    """Parse PAF text (one record per line, latin-1) into a PafTable."""
    return parse_paf_data(text.encode("latin-1"))


def parse_paf_data(data: bytes, parse_cigars: bool = True,
                   validate_cigars: bool = False) -> PafTable:
    """Parse PAF bytes into a PafTable with the native tokenizer.

    ``parse_cigars=False`` keeps each cg tag as an unparsed byte range
    (``PafTable.raw_cg``, the reference's parse_cigar_string=0 mode);
    ``validate_cigars`` (raw mode only) applies the full parser's cigar
    acceptance rule and parses fully when a cigar is non-canonical (a
    length with a leading zero).
    """
    if not parse_cigars:
        table = _parse_native_raw(data, validate_cigars)
        if table is not None:
            return table
    return _parse_native(data)


def _table(ints, flags, rtype, qnames, tnames, **cigar) -> PafTable:
    return PafTable(
        qname=qnames, qlen=ints[:, 0].copy(), qstart=ints[:, 1].copy(),
        qend=ints[:, 2].copy(), strand=(flags & 1).astype(bool),
        tname=tnames, tlen=ints[:, 3].copy(), tstart=ints[:, 4].copy(),
        tend=ints[:, 5].copy(), num_matches=ints[:, 6].copy(),
        num_bases=ints[:, 7].copy(), mapq=ints[:, 8].copy(),
        score=ints[:, 9].copy(), tile_level=ints[:, 10].copy(),
        chain_id=ints[:, 11].copy(), chain_score=ints[:, 12].copy(),
        type=rtype, has_cigar=(flags & 2).astype(bool), **cigar)


def _parse_native_raw(data: bytes, validate_cigars: bool) -> PafTable | None:
    try:
        res = native.parse_paf_bytes_raw(data, validate_cigars)
    except native.NativeParseError as e:
        raise PafFormatError(str(e), e.line_no) from e
    if res == "noncanon":
        return None
    ints, flags, rtype, qnames, tnames, cg_start, cg_len = res
    return _table(ints, flags, rtype, qnames, tnames,
                  ops=np.zeros(0, dtype=np.uint8),
                  lens=np.zeros(0, dtype=np.int64),
                  off=np.zeros(len(flags) + 1, dtype=np.int64),
                  raw_cg=(data, cg_start, cg_len))


def _parse_native(data: bytes) -> PafTable:
    try:
        res = native.parse_paf_bytes(data)
    except native.NativeParseError as e:
        raise PafFormatError(str(e), e.line_no) from e
    ints, flags, rtype, qnames, tnames, ops, lens, off = res
    return _table(ints, flags, rtype, qnames, tnames, ops=ops, lens=lens,
                  off=off)


def _table_to_arrays(t: PafTable):
    """The serializer's int64 [n, 13] field matrix and strand/cigar flags."""
    ints = native.pack_ints13((t.qlen, t.qstart, t.qend, t.tlen, t.tstart,
                               t.tend, t.num_matches, t.num_bases, t.mapq,
                               t.score, t.tile_level, t.chain_id,
                               t.chain_score))
    flags = t.strand.astype(np.uint8) | (t.has_cigar.astype(np.uint8) << 1)
    return ints, flags


def serialize_paf_bytes(t: PafTable, order=None) -> memoryview:
    """The records as PAF lines (the native serializer), as a zero-copy
    memoryview.  ``order`` (an int64 permutation) emits record order[r] at
    line r without reordering the table."""
    if len(t) == 0:
        return memoryview(b"")
    ints, flags = _table_to_arrays(t)
    return native.serialize_paf_arrays(ints, flags, t.type, t.qname, t.tname,
                                       t.ops, t.lens, t.off, order=order,
                                       raw_cig=t.raw_cg).data


def serialize_paf(t: PafTable) -> str:
    """The records as PAF lines, each with its newline, as a str (the
    native serializer's bytes read as latin-1)."""
    return bytes(serialize_paf_bytes(t)).decode("latin-1")


def read_paf_file(path_or_file) -> PafTable:
    """The table of a PAF file: a path, or a text file object."""
    if hasattr(path_or_file, "read"):
        return parse_paf_text(path_or_file.read())
    with open(path_or_file, "r") as fh:
        return parse_paf_text(fh.read())


def write_paf_file(t: PafTable, path_or_file) -> None:
    """``serialize_paf(t)`` to a path, or to a text file object."""
    data = serialize_paf(t)
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "w") as fh:
            fh.write(data)


def cigar_to_string(ops: np.ndarray, lens: np.ndarray) -> str:
    return "".join(f"{int(n)}{OP_TO_CHAR[int(o)]}" for o, n in zip(ops, lens))


def format_record(t: PafTable, i: int) -> str:
    """One record as a PAF line without its newline (paf_print; tag rules
    of impl/paf.c:317-389)."""
    line = "\t".join([
        str(t.qname[i]), str(t.qlen[i]), str(t.qstart[i]), str(t.qend[i]),
        "+" if t.strand[i] else "-",
        str(t.tname[i]), str(t.tlen[i]), str(t.tstart[i]), str(t.tend[i]),
        str(t.num_matches[i]), str(t.num_bases[i]), str(t.mapq[i])])
    ty, tl = int(t.type[i]), int(t.tile_level[i])
    if ty != 0 or tl != -1:
        line += "\ttp:A:" + (chr(ty) if ty != 0 else ("S" if tl > 1 else "P"))
    if int(t.score[i]) != INT_MAX:
        line += f"\tAS:i:{int(t.score[i])}"
    if tl != -1:
        line += f"\ttl:i:{tl}"
    if int(t.chain_id[i]) != -1:
        line += f"\tcn:i:{int(t.chain_id[i])}"
    if int(t.chain_score[i]) != -1:
        line += f"\ts1:i:{int(t.chain_score[i])}"
    if t.has_cigar[i]:
        if t.raw_cg is not None:
            buf, cs, cl = t.raw_cg
            line += "\tcg:Z:" + bytes(
                buf[int(cs[i]): int(cs[i]) + int(cl[i])]).decode("latin-1")
        else:
            s, e = t.off[i], t.off[i + 1]
            line += "\tcg:Z:" + cigar_to_string(t.ops[s:e], t.lens[s:e])
    return line


class PafCheckError(ValueError):
    """A record failed paf_check.  ``table``/``record_index`` name the first
    bad record of the checked table, so a streaming caller can emit the
    records before it."""

    def __init__(self, msg, table=None, record_index=None):
        super().__init__(msg)
        self.table = table
        self.record_index = record_index


def _raw_span_first_bad(t: PafTable) -> tuple[int, int]:
    """(record, code) of the first raw cigar whose spans differ from the
    record's query/target lengths, or (-1, -1); the query check comes first
    at a record, as in the reference (impl/paf.c:448-458)."""
    st = native.cigar_stats_raw(t)
    aligned = st[:, 0] + st[:, 1]          # M/= + X
    qbad = t.has_cigar & ((aligned + st[:, 4]) != (t.qend - t.qstart))
    tbad = t.has_cigar & ((aligned + st[:, 5]) != (t.tend - t.tstart))
    either = np.flatnonzero(qbad | tbad)
    if len(either) == 0:
        return -1, -1
    i = int(either[0])
    return i, (4 if qbad[i] else 5)


def paf_check(t: PafTable, idx=None, check_raw_spans: bool = False) -> None:
    """Raise PafCheckError at the first record whose coordinates are out of
    bounds or whose cigar spans differ from its query/target lengths
    (paf_check, impl/paf.c:427-461).  ``idx`` (ascending record indices)
    checks those records only; the error still names the record in ``t``.

    A raw-cigar table skips the span checks, as the reference does for
    unparsed cigars, unless ``check_raw_spans``: then the spans are summed
    from the cg text, for a raw-reading command whose reference parses its
    cigars and so checks them (trim, impl/paf_trim.c:116-124)."""
    if len(t) == 0:
        return
    if idx is not None:
        idx = np.asarray(idx, dtype=np.int64)
        if len(idx) == 0:
            return
        bad, code = native.paf_check_batch(t.take(idx))
        if bad >= 0:
            bad = int(idx[bad])
            raise PafCheckError(
                f"{_CHECK_MESSAGES[code]}, {format_record(t, bad)}",
                table=t, record_index=bad)
        return
    bad, code = native.paf_check_batch(t)
    if check_raw_spans and t.raw_cg is not None:
        sbad, scode = _raw_span_first_bad(t)
        # the first bad record wins; at one record the coordinate checks
        # come before the span checks
        if sbad >= 0 and (bad < 0 or sbad < bad):
            bad, code = sbad, scode
    if bad >= 0:
        raise PafCheckError(f"{_CHECK_MESSAGES[code]}, {format_record(t, bad)}",
                            table=t, record_index=bad)
