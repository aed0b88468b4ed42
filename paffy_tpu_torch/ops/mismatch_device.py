"""K2, the extended pool (counterpart of paffy_tpu/ops/mismatch_device.py:22-59:
``device_upper``, ``device_comp_upper``, ``build_ext_pool``).

``build_ext_pool(pool)`` turns the guarded u8 pool [L] into
``ext`` [2L] = upper(pool) ++ comp(upper(flip(pool))): the compare kernel
(K1, ops/compare.py) then reads both sides of every column as a plain
ascending byte range and tests byte equality -- case folding is applied,
and a reverse-complement query walk from pool position s is the ascending
read of ext from 2L-1-s.

On a CUDA tensor the wrapper launches the CUDA kernel (csrc/ext_pool.cu);
on a CPU tensor it runs the plain PyTorch version below, which is also what
the kernel is checked against on the card.
"""

from __future__ import annotations

import torch

from paffy_tpu_torch import kernels
from paffy_tpu_torch.core.fasta import COMPLEMENT_TABLE, UPPER_TABLE

# comp(upper(c)) for every byte c (IUPAC; W/S/N/X complement to
# themselves, as does every byte that is no base)
COMP_UPPER_TABLE = COMPLEMENT_TABLE[UPPER_TABLE]


def device_upper(c: torch.Tensor) -> torch.Tensor:
    """toupper of a u8 tensor."""
    return torch.where((c >= 97) & (c <= 122), c - 32, c)


def build_ext_pool_plain(pool: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: ``torch.where`` for the case fold, a 256-entry
    table for the complement of the flipped half."""
    lut = torch.from_numpy(COMP_UPPER_TABLE).to(pool.device)
    return torch.cat([device_upper(pool), lut[pool.flip(0).long()]])


def build_ext_pool(pool: torch.Tensor) -> torch.Tensor:
    """pool u8 [L] -> ext u8 [2L]; the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if pool.dtype != torch.uint8 or pool.dim() != 1:
        raise ValueError(f"pool must be a 1-D uint8 tensor, got "
                         f"{pool.dtype} of shape {tuple(pool.shape)}")
    if pool.device.type == "cpu":
        return build_ext_pool_plain(pool)
    dev = kernels.check_device(pool.device)
    pool = pool.contiguous()
    n = pool.numel()
    ext = torch.empty(2 * n, dtype=torch.uint8, device=pool.device)
    if n == 0:
        return ext
    rc = kernels.load().paffy_build_ext(dev, pool.data_ptr(), n,
                                        ext.data_ptr(),
                                        kernels.stream_of(pool))
    kernels.check(rc, "build_ext")
    kernels.count_launch("build_ext")
    return ext


def column_runs_plain(ext: torch.Tensor, table: torch.Tensor):
    """Per-column run flags over the pieces of a K4 table (ops/runs.py;
    counterpart of paffy_tpu/ops/mismatch_device.py::_column_runs): for
    every column, in column order, (piece, run start, match state).  A
    column starts a run when it is its M op's first column or its state
    differs from the previous column's; a piece's first column that is not
    its op's first compares with the column before it, re-read from ext."""
    qsrc, tsrc, n, _, first = table.unbind(0)
    dev = ext.device
    total = int(n.sum())
    piece = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n,
                                    output_size=total)
    i = torch.arange(total, device=dev) - (torch.cumsum(n, 0) - n)[piece]
    q, t = qsrc[piece] + i, tsrc[piece] + i
    eq = ext[q] == ext[t]
    # an op's first column reads no previous column (clamped, then masked)
    prev = ext[(q - 1).clamp_min(0)] == ext[(t - 1).clamp_min(0)]
    start = (eq != prev) | ((i == 0) & (first[piece] != 0))
    return piece, start, eq
