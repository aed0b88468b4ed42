"""K5, the greedy tile sweep on the device (counterpart of
paffy_tpu/ops/tile_device.py: ``_tile_scan`` :23, ``_tile_scan_groups``
:78).

``tile_sweep`` takes the arguments of the C sweep (native.tile_sweep), as
tensors: the processing order, each record's offset into one count arena
(each distinct query sequence's counts laid end to end), the records'
aligned query intervals in CSR form (run_off, istart, iend), the arena and
the saturation cap.  It adds each record's bases into the arena in order,
saturating at the cap, and returns the levels: the ((n+1)//2)-th smallest
of a record's n new counts, or EMPTY_TILE_LEVEL without an aligned base.
The arena is int16 on the PyTorch side (every count is <= 32766, so its
bits are the uint16 counts the reference keeps) and is updated in place.

On a CUDA tensor the wrapper groups the order by sequence (stable: records
on different query sequences commute) and launches the CUDA kernel
(csrc/tile_sweep.cu), one block per query sequence; on a CPU tensor it
runs the plain PyTorch version below, a loop over the records.
"""

from __future__ import annotations

import torch

from paffy_tpu_torch import kernels
from paffy_tpu_torch.ops.coverage import EMPTY_TILE_LEVEL, SATURATION


def tile_sweep_plain(order, arena_off, run_off, istart, iend, arena,
                     cap: int = SATURATION) -> torch.Tensor:
    """Plain PyTorch K5: one record at a time, its bases gathered from its
    intervals, incremented, written back and their k-th value taken."""
    levels = torch.full((run_off.numel() - 1,), EMPTY_TILE_LEVEL,
                        dtype=torch.int64, device=arena.device)
    ro, ao = run_off.tolist(), arena_off.tolist()
    for i in order.tolist():
        s, e = istart[ro[i]: ro[i + 1]], iend[ro[i]: ro[i + 1]]
        ln = e - s
        n = int(ln.sum()) if ln.numel() else 0
        if n == 0:
            continue
        pos = (torch.repeat_interleave(s - (torch.cumsum(ln, 0) - ln), ln,
                                       output_size=n)
               + torch.arange(n, device=arena.device) + ao[i])
        c = torch.clamp(arena[pos].to(torch.int32) + 1, max=cap)
        arena[pos] = c.to(torch.int16)
        levels[i] = torch.kthvalue(c, (n + 1) // 2).values
    return levels


def tile_sweep(order, arena_off, run_off, istart, iend, arena,
               cap: int = SATURATION) -> torch.Tensor:
    """int64 [n_records] tile levels (the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors); ``arena`` is updated in place.  All
    index tensors are int64; ``arena`` is int16."""
    idx = (order, arena_off, run_off, istart, iend)
    if any(x.dtype != torch.int64 or x.dim() != 1 for x in idx):
        raise ValueError("order, arena_off, run_off, istart and iend must be "
                         "1-D int64 tensors")
    if arena.dtype != torch.int16 or arena.dim() != 1:
        raise ValueError(f"arena must be a 1-D int16 tensor, got "
                         f"{arena.dtype} of shape {tuple(arena.shape)}")
    if any(x.device != arena.device for x in idx):
        raise ValueError("every tensor must be on the arena's device")
    if not 1 <= cap <= SATURATION:
        raise ValueError(f"cap must be in [1, {SATURATION}], got {cap}")
    if arena_off.numel() != run_off.numel() - 1:
        raise ValueError("arena_off and run_off must cover the same records")
    if arena.device.type == "cpu":
        return tile_sweep_plain(order, arena_off, run_off, istart, iend,
                                arena, cap)
    kernels.check_device(arena.device)
    if not arena.is_contiguous():
        raise ValueError("arena must be contiguous")
    n = run_off.numel() - 1
    levels = torch.full((n,), EMPTY_TILE_LEVEL, dtype=torch.int64,
                        device=arena.device)
    if order.numel() == 0:
        return levels
    # group the order by sequence, keeping each sequence's records in order
    key = arena_off[order]
    perm = torch.sort(key, stable=True).indices
    by_seq = order[perm].contiguous()
    counts = torch.unique_consecutive(key[perm], return_counts=True)[1]
    seq_off = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                          device=arena.device)
    torch.cumsum(counts, 0, out=seq_off[1:])
    lib = kernels.load()
    arena_off, run_off = arena_off.contiguous(), run_off.contiguous()
    istart, iend = istart.contiguous(), iend.contiguous()
    rc = lib.paffy_tile_sweep(
        counts.numel(), seq_off.data_ptr(), by_seq.data_ptr(),
        arena_off.data_ptr(), run_off.data_ptr(), istart.data_ptr(),
        iend.data_ptr(), arena.data_ptr(), cap, levels.data_ptr(),
        kernels.stream_of(arena))
    kernels.check(rc, "tile_sweep")
    kernels.LAUNCHES["tile_sweep"] += 1
    return levels
