"""FASTA reading into the flat sequence pool, FASTA text reading and
writing, base complementing, and the ``name|length|start`` header codec of
chunked sequences (counterpart of paffy_tpu/core/fasta.py, with
``COMPLEMENT_TABLE`` :32, ``UPPER_TABLE`` :38, ``reverse_complement_char``
:43, ``reverse_complement`` :47, ``load_sequences`` :159 and
``seq_to_bytes`` :213).

A header is the whole line after '>' with trailing whitespace stripped
(sonLib's semantics); sequence lines are wrap-agnostic.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from paffy_tpu_torch import native

# each base's complement, IUPAC ambiguity codes included, case kept
# (sonLib's); every other character is its own complement
_COMP = {
    "a": "t", "c": "g", "g": "c", "t": "a",
    "A": "T", "C": "G", "G": "C", "T": "A",
    "m": "k", "r": "y", "w": "w", "s": "s", "y": "r", "k": "m",
    "v": "b", "h": "d", "d": "h", "b": "v", "n": "n", "x": "x",
    "M": "K", "R": "Y", "W": "W", "S": "S", "Y": "R", "K": "M",
    "V": "B", "H": "D", "D": "H", "B": "V", "N": "N", "X": "X",
}
_COMP_TRANS = str.maketrans(_COMP)

COMPLEMENT_TABLE = np.arange(256, dtype=np.uint8)
COMPLEMENT_TABLE[[ord(k) for k in _COMP]] = [ord(v) for v in _COMP.values()]

# a-z to A-Z, every other byte kept (the toupper of paf_encode_mismatches,
# impl/paf.c:755-757)
UPPER_TABLE = np.arange(256, dtype=np.uint8)
UPPER_TABLE[ord("a"): ord("z") + 1] -= 32


def reverse_complement_char(c: str) -> str:
    return _COMP.get(c, c)


def reverse_complement(s: str) -> str:
    return s[::-1].translate(_COMP_TRANS)


def seq_to_bytes(seq: str) -> np.ndarray:
    """A sequence as a uint8 array of its latin-1 bytes."""
    return np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)


def fasta_pool_from_bytes(datas: list[bytes], n_threads: int | None = None):
    """(pool: uint8 array, index {name: (offset, length)}) built straight
    from FASTA file bytes, concatenated in order, by ``native.fasta_pack``.
    A duplicate name keeps its last occurrence in the index (both copies'
    bytes stay in the pool)."""
    pool, records, _ = native.fasta_pack(
        datas, lambda n: np.empty(n, dtype=np.uint8), n_threads)
    return pool, pool_index(records)


def pool_index(records) -> dict[str, tuple[int, int]]:
    """{name: (offset, length)} of ``native.fasta_pack``'s records; a
    repeated name takes its last record."""
    return {name: (off, ln) for name, off, ln in records}


def pack_sequences(seqs: dict[str, str]
                   ) -> tuple[np.ndarray, dict[str, tuple[int, int]]]:
    """(pool, {name: (offset, length)}): the sequences concatenated into
    one uint8 array."""
    pool = np.empty(sum(len(s) for s in seqs.values()), dtype=np.uint8)
    index: dict[str, tuple[int, int]] = {}
    pos = 0
    for name, s in seqs.items():
        b = seq_to_bytes(s)
        pool[pos:pos + len(b)] = b
        index[name] = (pos, len(b))
        pos += len(b)
    return pool, index


def _read_text(path_or_file) -> str:
    if hasattr(path_or_file, "read"):
        return path_or_file.read()
    with open(path_or_file, "r") as fh:
        return fh.read()


def read_fasta_list(path_or_file) -> list[tuple[str, str]]:
    """[(header, sequence)] in file order, duplicates kept.  A header is the
    whole line after '>' with trailing whitespace stripped; sequence lines
    are stripped and joined; empty lines and text before the first header
    are skipped."""
    out: list[tuple[str, str]] = []
    name = None
    chunks: list[str] = []
    for line in _read_text(path_or_file).splitlines():
        if line.startswith(">"):
            if name is not None:
                out.append((name, "".join(chunks)))
            name = line[1:].rstrip()
            chunks = []
        elif line:
            chunks.append(line.strip())
    if name is not None:
        out.append((name, "".join(chunks)))
    return out


def read_fasta(path_or_file) -> dict[str, str]:
    """{header: sequence} in file order; a repeated header keeps its last
    sequence."""
    return dict(read_fasta_list(path_or_file))


def load_sequences(paths: list[str]) -> dict[str, str]:
    """{name: sequence} of several FASTA files; a name repeated in a later
    file takes that file's sequence (repeated stHash inserts).  Each file
    is read as text by ``read_fasta``, as paffy_tpu reads it: the native
    pack (``fasta_pool_from_bytes``) reads bytes, and its lines and
    whitespace differ from the text reader's on files with other line
    ends than LF and CRLF, or with bytes outside ASCII."""
    seqs: dict[str, str] = {}
    for p in paths:
        seqs.update(read_fasta(p))
    return seqs


def write_fasta_record(fh, header: str, sequence: str,
                       line_width: int = 0) -> None:
    """One FASTA record: the sequence on one line with ``line_width`` 0,
    else wrapped every ``line_width`` characters, as sonLib's fastaWrite
    (impl/fasta_extract.c:35-51, impl/fasta_merge.c:47-84)."""
    fh.write(">")
    fh.write(header)
    fh.write("\n")
    if line_width > 0:
        for i in range(0, len(sequence), line_width):
            fh.write(sequence[i: i + line_width])
            fh.write("\n")
        if not sequence:
            fh.write("\n")
    else:
        fh.write(sequence)
        fh.write("\n")


class SequenceLineWriter:
    """Sequence lines written piece by piece, with the column carried
    across pieces (faffy merge's overlap-split pieces of one sequence).
    Width 0 writes each piece on a line of its own."""

    def __init__(self, fh, width: int = 0):
        self.fh = fh
        self.width = width
        self.col = 0

    def piece(self, s: str) -> None:
        if self.width <= 0:
            self.fh.write(s)
            self.fh.write("\n")
            return
        w = self.width
        while s:
            room = w - self.col
            self.fh.write(s[:room])
            if len(s) >= room:
                self.fh.write("\n")
                self.col = 0
            else:
                self.col += len(s)
            s = s[room:]

    def end(self) -> None:
        """End the current sequence (closes a part-filled wrapped line)."""
        if self.width > 0 and self.col:
            self.fh.write("\n")
            self.col = 0


def encode_header(name: str, length: int, start: int) -> str:
    """``name|length|start``, faffy chunk's header (impl/fasta_chunk.c:81)."""
    return f"{name}|{length}|{start}"


@dataclass
class Interval:
    name: str
    start: int
    end: int = 0
    length: int = 0


_LEADING_INT = re.compile(r"\s*[+-]?\d+")


def _sscanf_i64(s: str) -> int:
    """sscanf("%" PRIi64): leading whitespace, an optional sign and the
    leading digits; trailing text is ignored, so "12x" reads as 12
    (decode_fasta_header, impl/paf.c:719-725)."""
    m = _LEADING_INT.match(s)
    if m is None:
        raise ValueError(f"no leading integer in {s!r}")
    return int(m.group())


def decode_header(header: str) -> Interval:
    """``name|length|start`` -> Interval(name, start, length): the last two
    '|' fields are the start and the length, the rest rejoined with '|' is
    the name (decode_fasta_header, impl/paf.c:716-731)."""
    parts = header.split("|")
    if len(parts) < 3:
        raise ValueError(f"fasta header lacks |length|start provenance "
                         f"fields: {header!r}")
    start = _sscanf_i64(parts[-1])
    length = _sscanf_i64(parts[-2])
    return Interval(name="|".join(parts[:-2]), start=start, length=length)
