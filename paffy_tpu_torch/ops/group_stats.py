"""K7, the group stats of the mesh path (counterpart of
paffy_tpu/parallel/pipeline.py: ``_batched_group_tiled_stats`` :126, the
body of ``sharded_view_stats`` :171).

``group_stats`` adds, over the pieces of a piece table (ops/compare.py's
``build_piece_table``, with a slot in place of the record), each piece's
equal byte pairs to ``match[slot]``, its column count to ``cols[slot]``, and
the matches and mismatches of all pieces to ``totals[0]`` and
``totals[1]``.  The outputs are int64 and added to, never overwritten: a
mesh slot holds one seq range of a record group's pieces, so a record cut
over two ranges gets a partial count on each, and only their sum is its
count.  The caller zeroes them.

On a CUDA tensor the wrapper launches the CUDA kernel (csrc/group_stats.cu,
K1's walk with this epilogue); on a CPU tensor it runs the plain PyTorch
version below.
"""

from __future__ import annotations

import torch

from paffy_tpu_torch import kernels
from paffy_tpu_torch.ops.compare import WORD


def group_stats_plain(ext, table, match, cols, totals) -> None:
    """Plain PyTorch K7: gather both byte ranges column by column, compare,
    and ``index_add_`` the equal columns and every piece's column count
    into their slots."""
    qsrc, tsrc, n, slot = table.unbind(0)
    dev = ext.device
    total = int(n.sum())
    piece = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n,
                                    output_size=total)
    col = torch.arange(total, device=dev) - (torch.cumsum(n, 0) - n)[piece]
    eq = (ext[qsrc[piece] + col] == ext[tsrc[piece] + col]).to(torch.int64)
    match.index_add_(0, slot[piece], eq)
    cols.index_add_(0, slot, n)
    n_match = eq.sum()
    totals += torch.stack([n_match, n.sum() - n_match])


def group_stats(ext: torch.Tensor, table: torch.Tensor, match: torch.Tensor,
                cols: torch.Tensor, totals: torch.Tensor) -> None:
    """Add the stats of ``table``'s pieces to ``match`` and ``cols`` (int64
    [n_slots]) and ``totals`` (int64 [2]): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  ``ext``'s length must be a
    multiple of 16, and every slot of the table in [0, n_slots) (the host
    table builder checks both)."""
    if ext.dtype != torch.uint8 or ext.dim() != 1 or ext.numel() % WORD:
        raise ValueError(f"ext must be a 1-D uint8 tensor whose length is a "
                         f"multiple of {WORD}, got {ext.dtype} of shape "
                         f"{tuple(ext.shape)}")
    if (table.dtype != torch.int64 or table.dim() != 2
            or table.shape[0] != 4):
        raise ValueError(f"table must be int64 [4, n_pieces], got "
                         f"{table.dtype} of shape {tuple(table.shape)}")
    outs = (match, cols, totals)
    if (any(x.dtype != torch.int64 or x.dim() != 1 for x in outs)
            or cols.shape != match.shape or totals.numel() != 2):
        raise ValueError("match and cols must be int64 [n_slots], totals "
                         "int64 [2]")
    if any(x.device != ext.device for x in (table, *outs)):
        raise ValueError("every tensor must be on ext's device")
    if ext.device.type == "cpu":
        group_stats_plain(ext, table, match, cols, totals)
        return
    dev = kernels.check_device(ext.device)
    if match.numel() >= 2**31:
        raise ValueError(f"{match.numel()} slots: the kernel's slot index is "
                         f"int32")
    if not all(x.is_contiguous() for x in (ext, *outs)):
        raise ValueError("ext and the outputs must be contiguous")
    if ext.data_ptr() % WORD:
        raise ValueError(f"ext must start on a {WORD}-byte boundary")
    table = table.contiguous()
    n_pieces = table.shape[1]
    if n_pieces == 0:
        return
    rc = kernels.load().paffy_group_stats(
        dev, ext.data_ptr(), ext.numel(), table.data_ptr(), n_pieces,
        match.data_ptr(), cols.data_ptr(), totals.data_ptr(),
        kernels.stream_of(ext))
    kernels.check(rc, "group_stats")
    kernels.count_launch("group_stats")
