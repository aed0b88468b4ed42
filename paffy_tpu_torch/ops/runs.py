"""K4, =/X run extraction (counterpart of paffy_tpu/ops/tiled.py:
``_tiled_boundaries`` :273, ``_count_runs_tiled`` :302,
``_extract_runs_tiled`` :307, ``tiled_runs`` :343; of
paffy_tpu/ops/mismatch_device.py ``_column_runs`` :107; and of the host
placement after them, paffy_tpu/ops/mismatch.py:391-437).

Host side, ``build_run_table`` cuts the M ops of a column batch into K1's
pieces (ops/compare.py: a run cut every 4096 columns from its first
aligned target word) and writes, per piece, its query and target source
offsets in ``ext``, its column count, the batch-global index of its first
column, and whether it is its M op's first piece.  Device side, two CUDA
kernels (csrc/encode_runs.cu): ``run_counts`` gives each piece's number of
run starts, and ``run_fill_cigar``, given each piece's first slot in the
rebuilt cigar (``piece_first_dest``, reckoned on the host from the counts
and the CSR rebuild), writes every run's op code and length at its final
slot, as the C fill pass ``native.encode_runs_fill_cigar`` does on the
host.  On a CPU tensor each wrapper runs its plain PyTorch version (over
mismatch_device.column_runs_plain).

A run starts at its M op's first column or where the match state flips,
so runs never cross ops; a run's length is its column count, from its
start to the next start of its op or the op's end.
"""

from __future__ import annotations

import numpy as np
import torch

from paffy_tpu_torch import devconf, kernels
from paffy_tpu_torch.core.model import SEQ_MATCH, SEQ_MISMATCH
from paffy_tpu_torch.ops.compare import WORD, cut_runs, piece_sources
from paffy_tpu_torch.ops.mismatch_device import column_runs_plain

ROWS = 5      # qsrc, tsrc, n, col, first


def build_run_table(lens, qpos0, tpos0, rev, col_off, pool_len: int):
    """(table int64 [5, n_pieces], piece_off int64 [n_mops + 1]) for the M
    ops given (a ``MColumnBatch``'s arrays sliced to ``[:n_mops]``;
    ``col_off`` is its exclusive cumsum of lens).  ``piece_off[j]`` is M op
    j's first piece; a zero-length op has none."""
    mop, c0, n, piece_off = cut_runs(lens, tpos0)
    table = np.empty((ROWS, len(n)), dtype=np.int64)
    table[0], table[1] = piece_sources(qpos0, tpos0, rev, pool_len, mop, c0,
                                       n)
    table[2] = n
    table[3] = np.asarray(col_off, dtype=np.int64)[mop] + c0
    table[4] = c0 == 0
    return table, piece_off


def run_counts_plain(ext: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K4 count: the run starts of each piece."""
    piece, start, _ = column_runs_plain(ext, table)
    return torch.zeros(table.shape[1], dtype=torch.int32,
                       device=ext.device).index_add_(0, piece,
                                                     start.to(torch.int32))


def runs_per_mop(per_piece: np.ndarray, piece_off: np.ndarray
                 ) -> np.ndarray:
    """int64 [n_mops]: the runs of each M op, from the counts read back
    (``per_piece``) and ``build_run_table``'s ``piece_off``."""
    cs = np.zeros(len(per_piece) + 1, dtype=np.int64)
    np.cumsum(per_piece, out=cs[1:])
    return cs[piece_off[1:]] - cs[piece_off[:-1]]


def piece_first_dest(per_piece: np.ndarray, piece_off: np.ndarray,
               m_out_off: np.ndarray) -> np.ndarray:
    """int64 [n_pieces]: each piece's first slot in the rebuilt cigar, its
    M op's first slot (``m_out_off``, from the rebuild) plus the runs of
    the op's earlier pieces.  O(pieces)."""
    cs = np.zeros(len(per_piece) + 1, dtype=np.int64)
    np.cumsum(per_piece, out=cs[1:])
    mop = np.repeat(np.arange(len(piece_off) - 1), np.diff(piece_off))
    return (np.asarray(m_out_off, dtype=np.int64)
            - cs[piece_off[:-1]])[mop] + cs[:-1]


def placed_cigar(total_out: int, slot, keep_ops, keep_lens,
                 dev: torch.device):
    """(new_ops uint8 [total_out], new_lens int64 [total_out]) on ``dev``
    with the non-M ops (``native.encode_rebuild_slots``' packed ones)
    uploaded and placed at their slots; the M runs' slots are left for
    ``run_fill_cigar``."""
    new_ops = torch.empty(total_out, dtype=torch.uint8, device=dev)
    new_lens = torch.empty(total_out, dtype=torch.int64, device=dev)
    at = devconf.upload(slot, dev)
    new_ops[at] = devconf.upload(keep_ops, dev)
    new_lens[at] = devconf.upload(keep_lens, dev)
    return new_ops, new_lens


def run_fill_cigar_plain(ext: torch.Tensor, table: torch.Tensor,
                         first_dest: torch.Tensor, new_ops: torch.Tensor,
                         new_lens: torch.Tensor) -> None:
    """Plain PyTorch K4 fill: each run's op code (SEQ_MATCH or
    SEQ_MISMATCH, from the state of its first column) and length (its
    column count) into ``new_ops`` / ``new_lens`` at its piece's
    ``first_dest`` plus its rank among the piece's runs."""
    piece, start, eq = column_runs_plain(ext, table)
    # each column's run; every op's first column starts one, so a run's
    # columns reach from its start to the next start or its op's end
    run = torch.cumsum(start, 0) - 1
    cols = torch.nonzero(start).squeeze(1)
    lens = torch.bincount(run[run >= 0], minlength=cols.numel())
    p = piece[cols]
    per_piece = torch.bincount(p, minlength=table.shape[1])
    rank = (torch.arange(cols.numel(), device=ext.device)
            - (torch.cumsum(per_piece, 0) - per_piece)[p])
    dest = first_dest[p] + rank
    new_ops[dest] = torch.where(eq[cols], SEQ_MATCH,
                                SEQ_MISMATCH).to(torch.uint8)
    new_lens[dest] = lens


def _check(ext: torch.Tensor, table: torch.Tensor) -> None:
    if ext.dtype != torch.uint8 or ext.dim() != 1 or ext.numel() % WORD:
        raise ValueError(f"ext must be a 1-D uint8 tensor whose length is a "
                         f"multiple of {WORD}, got {ext.dtype} of shape "
                         f"{tuple(ext.shape)}")
    if (table.dtype != torch.int64 or table.dim() != 2
            or table.shape[0] != ROWS):
        raise ValueError(f"table must be int64 [{ROWS}, n_pieces], got "
                         f"{table.dtype} of shape {tuple(table.shape)}")
    if table.device != ext.device:
        raise ValueError(f"ext on {ext.device} but table on {table.device}")
    if ext.device.type != "cpu":
        kernels.check_device(ext.device)
        if not ext.is_contiguous() or ext.data_ptr() % WORD:
            raise ValueError(f"ext must be contiguous and start on a {WORD}-"
                             f"byte boundary")


def run_counts(ext: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """int32 [n_pieces] run starts per piece of ``table`` (from
    ``build_run_table`` for this ``ext``): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(ext, table)
    if ext.device.type == "cpu":
        return run_counts_plain(ext, table)
    table = table.contiguous()
    # every piece's count is stored (no zeroing launch)
    counts = torch.empty(table.shape[1], dtype=torch.int32,
                         device=ext.device)
    if table.shape[1] == 0:
        return counts
    rc = kernels.load().paffy_run_counts(
        ext.device.index, ext.data_ptr(), ext.numel(), table.data_ptr(),
        table.shape[1], counts.data_ptr(), kernels.stream_of(ext))
    kernels.check(rc, "run_counts")
    kernels.count_launch("run_counts")
    return counts


def run_fill_cigar(ext: torch.Tensor, table: torch.Tensor,
                   first_dest: torch.Tensor, new_ops: torch.Tensor,
                   new_lens: torch.Tensor) -> None:
    """Write every run of ``table``'s pieces into the rebuilt cigar: its op
    code into ``new_ops`` (uint8) and its length into ``new_lens`` (int64)
    at slot ``first_dest[p]`` (int64 [n_pieces], see ``piece_first_dest``)
    plus its rank among piece p's runs.  The other slots are left as they
    are.
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    _check(ext, table)
    if (first_dest.dtype != torch.int64
            or first_dest.shape != (table.shape[1],)
            or first_dest.device != ext.device):
        raise ValueError(f"first_dest must be int64 [{table.shape[1]}] on "
                         f"{ext.device}")
    if (new_ops.dtype != torch.uint8 or new_lens.dtype != torch.int64
            or new_ops.dim() != 1 or new_lens.shape != new_ops.shape
            or new_ops.device != ext.device
            or new_lens.device != ext.device):
        raise ValueError(f"new_ops and new_lens must be uint8 and int64 "
                         f"tensors of one length on {ext.device}")
    if ext.device.type == "cpu":
        run_fill_cigar_plain(ext, table, first_dest, new_ops, new_lens)
        return
    if not (new_ops.is_contiguous() and new_lens.is_contiguous()):
        raise ValueError("new_ops and new_lens must be contiguous")
    if table.shape[1] == 0:
        return
    table, first_dest = table.contiguous(), first_dest.contiguous()
    rc = kernels.load().paffy_run_fill_cigar(
        ext.device.index, ext.data_ptr(), ext.numel(), table.data_ptr(),
        table.shape[1], first_dest.data_ptr(), new_ops.data_ptr(),
        new_lens.data_ptr(), kernels.stream_of(ext))
    kernels.check(rc, "run_fill_cigar")
    kernels.count_launch("run_fill_cigar")
