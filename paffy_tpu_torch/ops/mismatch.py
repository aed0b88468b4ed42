"""The sequence pool, per-record column counts and the =/X encoder
(counterpart of paffy_tpu/ops/mismatch.py: ``SequencePool`` :55,
``column_match_counts`` :274, ``encode_mismatches`` :347;
``first_missing_seq`` is paffy_tpu/commands/simple.py:246).

``SequencePool`` keeps the FASTA bytes in one guarded host array with a
name index; on the device it holds only ``ext`` (K2's output, a torch
tensor).  ``from_arrays`` builds it over given bytes and index, which is how
the tests hand paffy_tpu's pool across as numpy arrays.

``column_match_counts`` always runs the piece compare on the pool's device
(K1), and ``encode_mismatches`` the run extraction (K4): there is no host
route and no size threshold here, because the routing constants of
paffy_tpu (mismatch.py:219-222, 358-364) were measured on another machine
and the H100's have not been measured yet.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from paffy_tpu_torch import devconf, native, phases
from paffy_tpu_torch.core.fasta import pack_sequences, pool_index
from paffy_tpu_torch.core.model import PafTable
from paffy_tpu_torch.ops.compare import build_piece_table, piece_match_counts
from paffy_tpu_torch.ops.mismatch_device import build_ext_pool
from paffy_tpu_torch.ops.runs import (build_run_table, piece_first_dest,
                                      placed_cigar, run_counts,
                                      run_fill_cigar, runs_per_mop)
from paffy_tpu_torch.ops.segments import (POOL_GUARD, POOL_W,
                                          build_m_column_batch)


class SequencePool:
    """Guarded FASTA pool: bytes and name index on the host, ``ext`` on
    ``device`` (resolved by ``devconf.device`` when the pool is made).

    The host pool carries POOL_GUARD zero bytes before the sequences and at
    least POOL_GUARD after them, and its length is a multiple of POOL_W;
    every offset includes the front guard.
    """

    def __init__(self, seqs: dict[str, str]):
        self._init_from_pool(*pack_sequences(seqs))

    @classmethod
    def from_arrays(cls, pool_bytes: np.ndarray,
                    index: dict[str, tuple[int, int]]) -> "SequencePool":
        """The pool over ``pool_bytes`` (the sequences concatenated, no
        guards) and ``index`` {name: (offset, length)} into it."""
        self = cls.__new__(cls)
        self._init_from_pool(np.asarray(pool_bytes, dtype=np.uint8),
                             dict(index))
        return self

    @classmethod
    def from_fasta_files(cls, paths, n_threads: int | None = None
                         ) -> "SequencePool":
        """The pool straight from the FASTA files, timed as the phase
        "fasta": one threaded native pass (``native.fasta_pack_files``,
        ``n_threads`` as there) from the mapped files into the guarded
        buffer, which on a CUDA device is the pinned block that ``ext``
        uploads from.  While tracing, counts ``pool_threads``, the
        threads of the pass."""
        with phases.timed("fasta"):
            self = cls.__new__(cls)
            self.device = devconf.device()
            _, records, nt = native.fasta_pack_files(paths, self._guarded,
                                                     n_threads)
            phases.count(pool_threads=nt)
            self._init_ext(pool_index(records))
            return self

    def _init_from_pool(self, pool_np: np.ndarray, index) -> None:
        self.device = devconf.device()
        self._guarded(len(pool_np))[:] = pool_np
        self._init_ext(index)

    def _guarded(self, n_data: int) -> np.ndarray:
        """Allocates the guarded host pool for ``n_data`` sequence bytes,
        its guard and tail zeroed, and gives the view the sequences go
        to.  On a CUDA device it is a pinned block of torch's caching host
        allocator (the array's base holds it), which ``ext`` uploads from
        in place."""
        n = POOL_GUARD + n_data
        padded = -(-(n + POOL_GUARD + 2 * POOL_W) // POOL_W) * POOL_W
        if self.device.type == "cuda":
            buf = torch.empty(padded, dtype=torch.uint8,
                              pin_memory=True).numpy()
        else:
            buf = np.empty(padded, dtype=np.uint8)
        buf[:POOL_GUARD] = 0
        buf[n:] = 0
        self._guard = POOL_GUARD
        self._data_len = n_data
        self._pool_np = buf
        return buf[POOL_GUARD: n]

    def _init_ext(self, index) -> None:
        self.index = index
        self._ext_t = None
        self._ext_copies: dict[torch.device, torch.Tensor] = {}
        # ext and its copies are made once, whichever threads ask at once
        self._ext_lock = threading.RLock()

    @property
    def pool_len(self) -> int:
        """Length L of the guarded pool (ext has 2L bytes)."""
        return len(self._pool_np)

    @property
    def host_pool(self) -> np.ndarray:
        """The guarded pool on the host (for the native C passes)."""
        return self._pool_np

    def seq_bytes(self, name: str) -> np.ndarray:
        """One sequence's bytes as a host uint8 view into the pool."""
        off, ln = self.index[name]
        g = self._guard
        return self._pool_np[g + off: g + off + ln]

    def offsets_for(self, names: np.ndarray, role: str) -> np.ndarray:
        """Guarded pool offset of each named sequence, one dictionary probe
        per distinct name; KeyError with the reference's message for the
        missing name of the lowest record."""
        ids, keys, _ = native.first_seen_ids(names)
        off = np.empty(len(keys), dtype=np.int64)
        for k, n in enumerate(keys):
            entry = self.index.get(n)
            if entry is None:
                raise KeyError(f"No {role} sequence named: {n} found")
            off[k] = entry[0] + self._guard
        return off[ids]

    def first_missing_seq(self, t: PafTable):
        """(record, role, name) of the first record whose query (checked
        first, the reference's fetch order) or target sequence is not in
        the pool; (-1, None, None) when all resolve.  One dictionary probe
        per distinct name of each side."""
        q, tg = self._missing(t.qname), self._missing(t.tname)
        bad = np.flatnonzero(q | tg)
        if len(bad) == 0:
            return -1, None, None
        i = int(bad[0])
        return (i, "query", t.qname[i]) if q[i] else (i, "target", t.tname[i])

    def _missing(self, names) -> np.ndarray:
        ids, keys, _ = native.first_seen_ids(names)
        return ~np.fromiter((k in self.index for k in keys), dtype=bool,
                            count=len(keys))[ids]

    @property
    def ext(self) -> torch.Tensor:
        """u8 [2 * pool_len] extended pool on ``device``, built on first use
        from the host pool, once: a thread that asks while another builds
        it waits for that build.  On CUDA the upload copies from the pinned
        host pool in place (the phase's closing synchronize ends the copy
        before the pool can free its block); while tracing it counts
        ``pool_direct``, 1 when it did, 0 when it staged through a pinned
        copy.  The raw pool's
        device copy is freed once ext exists: the compare reads only ext."""
        with self._ext_lock:
            if self._ext_t is None:
                with phases.timed("pool upload", self.device):
                    if self.device.type == "cuda":
                        phases.count(pool_direct=int(
                            torch.from_numpy(self._pool_np).is_pinned()))
                    raw = devconf.upload(self._pool_np, self.device)
                with phases.timed("K2", self.device):
                    self._ext_t = build_ext_pool(raw)
                del raw
            return self._ext_t

    def ext_on(self, dev: torch.device) -> torch.Tensor:
        """``ext`` on ``dev``: the same tensor on the pool's own device,
        elsewhere one device-to-device copy, kept per device (the
        replication of ``ext`` over a mesh)."""
        dev = torch.device(dev)
        if dev == self.device:
            return self.ext
        with self._ext_lock:
            if dev not in self._ext_copies:
                self._ext_copies[dev] = self.ext.to(dev)
            return self._ext_copies[dev]

    def subset(self, names) -> "SequencePool":
        """A pool of only the sequences ``names`` that this pool holds, in
        the order given (a process's own shards' sequences)."""
        keep = [n for n in names if n in self.index]
        parts = [self.seq_bytes(n) for n in keep]
        starts = np.cumsum([0] + [len(p) for p in parts])
        return SequencePool.from_arrays(
            np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8),
            {n: (int(s), len(p)) for n, s, p in zip(keep, starts, parts)})


def column_match_counts(t: PafTable, pool: SequencePool
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Per-record (match, mismatch) counts over the M runs of ``t``, int64
    on the host: K1 on the pool's device."""
    with phases.timed("batch"):
        b = build_m_column_batch(t, pool.offsets_for(t.qname, "query"),
                                 pool.offsets_for(t.tname, "target"))
    if b.n_cols == 0:
        z = np.zeros(len(t), dtype=np.int64)
        return z, z.copy()
    k = b.n_mops
    with phases.timed("pieces"):
        table = build_piece_table(b.lens[:k], b.qpos0[:k], b.tpos0[:k],
                                  b.rev[:k], b.rec[:k], pool.pool_len, len(t))
    ext = pool.ext
    with phases.timed("upload", pool.device):
        table = devconf.upload(table, pool.device)
    with phases.timed("kernel"):
        m = devconf.to_host_i64(piece_match_counts(ext, table, len(t)))
    return m, np.diff(b.rec_col_off) - m


def encode_mismatches(t: PafTable, pool: SequencePool) -> PafTable:
    """paf_encode_mismatches over a batch (impl/paf.c:739-784): every M op
    becomes its =/X runs, every other op (=/X ones included) stays in
    place; an M op of length 0 leaves nothing, as in paffy_tpu's fused
    encoder.  A batch without M ops comes back as it is.

    The cigar is assembled on the pool's device, as paffy_tpu's C pass pair
    assembles it on the host: K4 counts the runs of each piece; the host
    reads the counts back and rebuilds the CSR offsets (O(ops), plus each
    piece's first slot, O(pieces)); the non-M ops are uploaded and placed
    at their slots, K4's fill writes every run's op and length at its own,
    and the finished ops and lens come back in one download.
    """
    with phases.timed("batch"):
        b = build_m_column_batch(t, pool.offsets_for(t.qname, "query"),
                                 pool.offsets_for(t.tname, "target"))
    k = b.n_mops
    if k == 0:
        return t
    with phases.timed("pieces"):
        table, piece_off = build_run_table(b.lens[:k], b.qpos0[:k],
                                           b.tpos0[:k], b.rev[:k],
                                           b.col_off[:k], pool.pool_len)
    ext = pool.ext
    with phases.timed("upload", pool.device):
        table = devconf.upload(table, pool.device)
    with phases.timed("K4 count"):
        per_piece = devconf.to_host_i64(run_counts(ext, table))
    with phases.timed("rebuild", pool.device):
        out_off_per_op, m_out_off, slot, keep_ops, keep_lens = (
            native.encode_rebuild_slots(t.ops, t.lens,
                                        runs_per_mop(per_piece, piece_off)))
        dest = devconf.upload(
            piece_first_dest(per_piece, piece_off, m_out_off), pool.device)
        new_ops_d, new_lens_d = placed_cigar(int(out_off_per_op[-1]), slot,
                                             keep_ops, keep_lens, pool.device)
    with phases.timed("K4 fill", pool.device):
        run_fill_cigar(ext, table, dest, new_ops_d, new_lens_d)
    with phases.timed("download"):
        new_ops = devconf.download(new_ops_d)
        new_lens = devconf.download(new_lens_d)
    return t.with_cigars(new_ops, new_lens, out_off_per_op[t.off])
