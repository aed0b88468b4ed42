"""FASTA reading into the flat sequence pool (counterpart of
paffy_tpu/core/fasta.py).

A header is the whole line after '>' with trailing whitespace stripped
(sonLib's semantics); sequence lines are wrap-agnostic.
"""

from __future__ import annotations

import numpy as np

from paffy_tpu_torch import native


def fasta_pool_from_bytes(datas: list[bytes]):
    """(pool: uint8 array, index {name: (offset, length)}) built straight
    from FASTA file bytes by ``native.fasta_pack_bytes``.  A duplicate name
    keeps its last occurrence in the index (both copies' bytes stay in the
    pool)."""
    parts: list[np.ndarray] = []
    index: dict[str, tuple[int, int]] = {}
    pos = 0
    for data in datas:
        pool, records = native.fasta_pack_bytes(data)
        parts.append(pool)
        for name, off, ln in records:
            index[name] = (pos + off, ln)
        pos += len(pool)
    pool = (np.concatenate(parts) if len(parts) > 1
            else (parts[0] if parts else np.empty(0, dtype=np.uint8)))
    return pool, index


def pack_sequences(seqs: dict[str, str]
                   ) -> tuple[np.ndarray, dict[str, tuple[int, int]]]:
    """(pool, {name: (offset, length)}): the sequences concatenated into
    one uint8 array."""
    pool = np.empty(sum(len(s) for s in seqs.values()), dtype=np.uint8)
    index: dict[str, tuple[int, int]] = {}
    pos = 0
    for name, s in seqs.items():
        b = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
        pool[pos:pos + len(b)] = b
        index[name] = (pos, len(b))
        pos += len(b)
    return pool, index
