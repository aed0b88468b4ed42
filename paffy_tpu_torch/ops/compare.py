"""K1, the piece compare (counterpart of paffy_tpu/ops/pallas_compare.py:
``build_piece_batch`` :112, ``_piece_match_counts`` :230,
``_reduce_to_records`` :252, ``pallas_match_counts`` :267).

Host side, ``build_piece_table`` cuts each M run of a column batch into
pieces and writes, per piece, the ascending source offsets of its query and
target bytes in the extended pool ``ext`` (ops/mismatch_device.py), its
column count and its record.  Device side, ``piece_match_counts`` adds each
piece's equal byte pairs to its record's total: one CUDA kernel
(csrc/piece_compare.cu) on a CUDA tensor, the plain PyTorch version on a
CPU tensor.

The kernel walks a piece in windows of ``WINDOW`` = 512 target bytes, the
32 aligned 16-byte words a warp loads in one step, so the table needs no
entry per window: a piece is a whole M run, cut only every ``PIECE_COLS``
= 4096 columns to bound the work one warp takes on (a warp takes 32
consecutive pieces).  Every piece after a run's first starts on a
4096-byte boundary counted from the run's first aligned target word, so
it starts 16-aligned and fills its windows; a run whose target starts at
offset a mod 16 has ceil((n + a) / 4096) pieces.  The TPU kernel's
4096-column pieces were one vector register of bytes; here the cut only
balances the warps.

All offsets are int64: unlike the TPU kernel (``2L < 2**31``,
pallas_compare.py:146), pools of any size stay on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from paffy_tpu_torch import kernels

WORD = 16                      # bytes a lane loads at once
WINDOW = 32 * WORD             # target bytes a warp covers in one step
PIECE_COLS = 8 * WINDOW        # longest piece: a run is cut every 4096 columns


def build_piece_table(lens, qpos0, tpos0, rev, rec, pool_len: int,
                      n_records: int) -> np.ndarray:
    """int64 [4, n_pieces] rows (qsrc, tsrc, n, rec) for the M runs given.

    ``lens, qpos0, tpos0, rev, rec`` are the per-M-op arrays of a
    ``MColumnBatch`` sliced to ``[:n_mops]`` (its padded tail is not a run);
    positions index the guarded pool of length ``pool_len`` (L).  A forward
    piece reads pool[s, s+n) = ext[s, s+n); a reverse piece walks down from
    s = qpos0 - c0, which is the ascending read ext[2L-1-s, 2L-1-s+n).
    Raises ValueError if a piece would read outside its half of ext or a
    record index is outside [0, n_records): the kernel trusts the table.
    """
    rec = np.asarray(rec, dtype=np.int64)
    mop, c0, n, _ = cut_runs(lens, tpos0)
    table = np.empty((4, len(n)), dtype=np.int64)
    table[0], table[1] = piece_sources(qpos0, tpos0, rev, pool_len, mop, c0,
                                       n)
    table[2] = n
    table[3] = rec[mop]
    if len(n) and (table[3].min() < 0 or table[3].max() >= n_records):
        raise ValueError("an M run's record index is out of range")
    return table


def cut_runs(lens, tpos0):
    """The pieces of the M runs given: (mop, c0, n, off), the run of each
    piece, its first column within the run and its column count, and each
    run's first piece (``off``, length n_runs + 1).  A run is cut every
    PIECE_COLS columns counted from its first aligned target word; a
    zero-length run has no piece."""
    lens = np.asarray(lens, dtype=np.int64)
    tpos0 = np.asarray(tpos0, dtype=np.int64)
    if lens.size and lens.min() < 0:
        raise ValueError("negative M run length")
    head = tpos0 % WORD           # columns of the first word before the run
    nsub = np.where(lens > 0, -(-(lens + head) // PIECE_COLS), 0)
    off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(nsub, out=off[1:])
    mop = np.repeat(np.arange(len(lens)), nsub)
    k = np.arange(int(off[-1]), dtype=np.int64) - off[mop]
    c0 = np.maximum(k * PIECE_COLS - head[mop], 0)
    n = np.minimum((k + 1) * PIECE_COLS - head[mop], lens[mop]) - c0
    return mop, c0, n, off


def piece_sources(qpos0, tpos0, rev, pool_len: int, mop, c0, n):
    """(qsrc, tsrc): each piece's ascending query and target start in ext.
    Raises ValueError if a piece would read outside its half of ext: the
    kernels trust their tables."""
    qpos0 = np.asarray(qpos0, dtype=np.int64)
    tpos0 = np.asarray(tpos0, dtype=np.int64)
    rev = np.asarray(rev, dtype=bool)
    L = np.int64(pool_len)
    qsrc = np.where(rev, 2 * L - 1 - qpos0, qpos0)[mop] + c0
    tsrc = tpos0[mop] + c0
    if len(n):
        q_lo = np.where(rev[mop], L, 0)
        if (np.any(qsrc < q_lo) or np.any(qsrc + n > q_lo + L)
                or tsrc.min() < 0 or np.max(tsrc + n) > L):
            raise ValueError(f"an M run reads outside the sequence pool "
                             f"(pool length {pool_len})")
    return qsrc, tsrc


def piece_match_counts_plain(ext: torch.Tensor, table: torch.Tensor,
                             n_records: int) -> torch.Tensor:
    """Plain PyTorch K1: gather both byte ranges column by column, compare,
    and ``index_add_`` the equal columns into their records."""
    qsrc, tsrc, n, rec = table.unbind(0)
    dev = ext.device
    total = int(n.sum())
    piece = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n,
                                    output_size=total)
    col = (torch.arange(total, device=dev)
           - (torch.cumsum(n, 0) - n)[piece])
    eq = ext[qsrc[piece] + col] == ext[tsrc[piece] + col]
    return torch.zeros(n_records, dtype=torch.int64, device=dev).index_add_(
        0, rec[piece], eq.to(torch.int64))


def piece_match_counts(ext: torch.Tensor, table: torch.Tensor,
                       n_records: int) -> torch.Tensor:
    """int64 [n_records] match counts over the pieces of ``table`` (from
    ``build_piece_table`` for this ``ext``); the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  ``ext``'s length must be a
    multiple of 16 (the kernel reads it in aligned 16-byte words; a
    SequencePool's is, see ops/segments.py)."""
    if ext.dtype != torch.uint8 or ext.dim() != 1 or ext.numel() % WORD:
        raise ValueError(f"ext must be a 1-D uint8 tensor whose length is a "
                         f"multiple of {WORD}, got {ext.dtype} of shape "
                         f"{tuple(ext.shape)}")
    if (table.dtype != torch.int64 or table.dim() != 2
            or table.shape[0] != 4):
        raise ValueError(f"table must be int64 [4, n_pieces], got "
                         f"{table.dtype} of shape {tuple(table.shape)}")
    if table.device != ext.device:
        raise ValueError(f"ext on {ext.device} but table on {table.device}")
    if ext.device.type == "cpu":
        return piece_match_counts_plain(ext, table, n_records)
    dev = kernels.check_device(ext.device)
    if n_records >= 2**31:
        raise ValueError(f"{n_records} records: the kernel's record index is "
                         f"int32")
    ext, table = ext.contiguous(), table.contiguous()
    if ext.data_ptr() % WORD:
        raise ValueError(f"ext must start on a {WORD}-byte boundary")
    match = torch.zeros(n_records, dtype=torch.int64, device=ext.device)
    n_pieces = table.shape[1]
    if n_pieces == 0:
        return match
    rc = kernels.load().paffy_piece_counts(
        dev, ext.data_ptr(), ext.numel(), table.data_ptr(), n_pieces,
        match.data_ptr(), kernels.stream_of(ext))
    kernels.check(rc, "piece_compare")
    kernels.count_launch("piece_compare")
    return match
