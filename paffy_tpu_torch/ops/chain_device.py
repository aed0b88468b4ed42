"""K6, the windowed chain DP on the device (counterpart of
paffy_tpu/ops/chain_device.py: ``_dp_scan`` :26 and ``_dp_scan_groups``
:81, driven by ``chain_groups_device`` :94).

The arguments are the groups of one strand set laid end to end
(ops/chain.dp_arguments), int64 and without padding: group g holds slots
goff[g]..goff[g+1]; in processing order, slot i holds record i's qs, ts
and score, lo[i] and w[i] (its candidate window, slots [lo, lo + w) of the
query-end order) and pos[i] (its own slot in that order); in query-end
order, slot k holds qe_s, te_s and idx_s (the record's processing slot).
For each record in order,

  cs[i] = max(score[i], max_j score[i] + cs[j] - g(i, j))

over the j of its window with j < i, 0 <= tgap <= max_gap and g < score[i],
where g = 0 for a zero total gap and gap_open + gap_extend * (qgap + tgap)
otherwise; pred[i] is the best j, ties going to the largest (te[j], qe[j],
j), or -1 when no candidate beats score[i].  Every index is a slot.

On a CUDA tensor the wrapper launches the CUDA kernel (csrc/chain_dp.cu),
one block per group; on a CPU tensor it runs the plain PyTorch version
below, a loop over the records.
"""

from __future__ import annotations

import torch

from paffy_tpu_torch import kernels

NEG = -(1 << 62)      # "no candidate", as paffy_tpu's _NEG


def chain_dp_groups_plain(goff, qs, ts, score, qe_s, te_s, idx_s, lo, w, pos,
                          gap_open: int, gap_extend: int, max_gap: int):
    """Plain PyTorch K6: one record at a time over its window, the chain
    scores kept in query-end order (cs_sorted) as _dp_scan keeps them, the
    tie broken by nested maxima (_dp_scan :61-67).  ``goff`` is not read:
    no window crosses a group."""
    n = qs.numel()
    cs = score.clone()
    pred = torch.full((n,), -1, dtype=torch.int64, device=qs.device)
    cs_sorted = torch.full((n,), NEG, dtype=torch.int64, device=qs.device)
    lo_l, w_l, pos_l = lo.tolist(), w.tolist(), pos.tolist()
    qs_l, ts_l, sc_l = qs.tolist(), ts.tolist(), score.tolist()
    for i in range(n):
        a, b, s = lo_l[i], lo_l[i] + w_l[i], sc_l[i]
        if b > a:
            idx, qe, te = idx_s[a:b], qe_s[a:b], te_s[a:b]
            tgap = ts_l[i] - te
            gap = (qs_l[i] - qe) + tgap
            g = torch.where(gap == 0, 0, gap_open + gap_extend * gap)
            ok = (idx < i) & (tgap >= 0) & (tgap <= max_gap) & (g < s)
            val = torch.where(ok, s + cs_sorted[a:b] - g, NEG)
            best = int(val.max())
            if best > s:
                tie = val == best
                tie &= te == torch.where(tie, te, NEG).max()
                tie &= qe == torch.where(tie, qe, NEG).max()
                cs[i] = best
                pred[i] = torch.where(tie, idx, -1).max()
        cs_sorted[pos_l[i]] = cs[i]
    return cs, pred


def chain_dp_groups(goff, qs, ts, score, qe_s, te_s, idx_s, lo, w, pos,
                    gap_open: int, gap_extend: int, max_gap: int):
    """(cs, pred), int64 [n] in processing slots: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Every argument is a 1-D
    int64 tensor of n elements on one device, but ``goff`` (groups + 1)."""
    args = (goff, qs, ts, score, qe_s, te_s, idx_s, lo, w, pos)
    if any(x.dtype != torch.int64 or x.dim() != 1 for x in args):
        raise ValueError("every argument of chain_dp_groups must be a 1-D "
                         "int64 tensor")
    n = qs.numel()
    if goff.numel() < 1 or any(x.numel() != n for x in args[1:]):
        raise ValueError(f"qs, ts, score, qe_s, te_s, idx_s, lo, w and pos "
                         f"must have one length, and goff at least one "
                         f"element; got {[x.numel() for x in args]}")
    if any(x.device != qs.device for x in args):
        raise ValueError("every tensor must be on one device")
    if qs.device.type == "cpu":
        return chain_dp_groups_plain(*args, gap_open, gap_extend, max_gap)
    kernels.check_device(qs.device)
    cs = torch.empty(n, dtype=torch.int64, device=qs.device)
    pred = torch.empty_like(cs)
    if n == 0:
        return cs, pred
    cs_sorted = torch.empty_like(cs)      # scratch: cs in query-end order
    args = [x.contiguous() for x in args]
    rc = kernels.load().paffy_chain_dp(
        goff.numel() - 1, *(x.data_ptr() for x in args), gap_open,
        gap_extend, max_gap, cs_sorted.data_ptr(), cs.data_ptr(),
        pred.data_ptr(), kernels.stream_of(cs))
    kernels.check(rc, "chain_dp")
    kernels.LAUNCHES["chain_dp"] += 1
    return cs, pred
