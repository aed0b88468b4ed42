"""K4, =/X run extraction (counterpart of paffy_tpu/ops/tiled.py:
``_tiled_boundaries`` :273, ``_count_runs_tiled`` :302,
``_extract_runs_tiled`` :307, ``tiled_runs`` :343; and of
paffy_tpu/ops/mismatch_device.py ``_column_runs`` :107).

Host side, ``build_run_table`` cuts the M ops of a column batch into K1's
pieces (ops/compare.py: a run cut every 4096 columns from its first
aligned target word) and writes, per piece, its query and target source
offsets in ``ext``, its column count, the batch-global index of its first
column, and whether it is its M op's first piece.  Device side, two CUDA
kernels (csrc/encode_runs.cu): ``run_counts`` gives each piece's number of
run starts, and ``run_fill``, given each piece's first output index (an
exclusive scan of the counts), writes every run's start column and match
state in column order.  On a CPU tensor each wrapper runs its plain
PyTorch version (over mismatch_device.column_runs_plain).

A run starts at its M op's first column or where the match state flips,
so runs never cross ops; run lengths are the differences of consecutive
starts (the last run of the batch ends at its column count).
"""

from __future__ import annotations

import numpy as np
import torch

from paffy_tpu_torch import kernels
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
    piece, _, start, _ = column_runs_plain(ext, table)
    return torch.zeros(table.shape[1], dtype=torch.int32,
                       device=ext.device).index_add_(0, piece,
                                                     start.to(torch.int32))


def run_fill_plain(ext: torch.Tensor, table: torch.Tensor,
                   first_out: torch.Tensor, n_runs: int):
    """Plain PyTorch K4 fill: each run's start column (int64) and match
    state (uint8) at its piece's first output index plus its rank within
    the piece."""
    piece, i, start, eq = column_runs_plain(ext, table)
    cols = torch.nonzero(start).squeeze(1)
    p = piece[cols]
    per_piece = torch.bincount(p, minlength=table.shape[1])
    rank = (torch.arange(cols.numel(), device=ext.device)
            - (torch.cumsum(per_piece, 0) - per_piece)[p])
    dest = first_out[p] + rank
    starts = torch.empty(n_runs, dtype=torch.int64, device=ext.device)
    states = torch.empty(n_runs, dtype=torch.uint8, device=ext.device)
    starts[dest] = table[3][p] + i[cols]
    states[dest] = eq[cols].to(torch.uint8)
    return starts, states


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
    counts = torch.zeros(table.shape[1], dtype=torch.int32,
                         device=ext.device)
    if table.shape[1] == 0:
        return counts
    rc = kernels.load().paffy_run_counts(
        ext.data_ptr(), ext.numel(), table.data_ptr(), table.shape[1],
        counts.data_ptr(), kernels.stream_of(ext))
    kernels.check(rc, "run_counts")
    kernels.LAUNCHES["run_counts"] += 1
    return counts


def run_fill(ext: torch.Tensor, table: torch.Tensor, first_out: torch.Tensor,
             n_runs: int):
    """(starts int64 [n_runs], states uint8 [n_runs]): every run's
    batch-global start column and match state, piece by piece from
    ``first_out`` (int64 [n_pieces], the exclusive scan of ``run_counts``),
    in column order.  The CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check(ext, table)
    if (first_out.dtype != torch.int64
            or first_out.shape != (table.shape[1],)
            or first_out.device != ext.device):
        raise ValueError(f"first_out must be int64 [{table.shape[1]}] on "
                         f"{ext.device}")
    if ext.device.type == "cpu":
        return run_fill_plain(ext, table, first_out, n_runs)
    table, first_out = table.contiguous(), first_out.contiguous()
    starts = torch.empty(n_runs, dtype=torch.int64, device=ext.device)
    states = torch.empty(n_runs, dtype=torch.uint8, device=ext.device)
    if table.shape[1] == 0:
        return starts, states
    rc = kernels.load().paffy_run_fill(
        ext.data_ptr(), ext.numel(), table.data_ptr(), table.shape[1],
        first_out.data_ptr(), starts.data_ptr(), states.data_ptr(),
        kernels.stream_of(ext))
    kernels.check(rc, "run_fill")
    kernels.LAUNCHES["run_fill"] += 1
    return starts, states
