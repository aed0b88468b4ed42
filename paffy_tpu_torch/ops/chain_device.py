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
one block per group: a walker warp that takes the K most recent candidates
of each record itself, and helper warps that reduce the older ones ahead
of it; on a CPU tensor it runs the plain PyTorch version below, a loop
over the records.  ``chain_dp_split_plain`` is the plain emulation of that
split, for the tests.  ``chain_groups_device`` drives the wrapper for a
list of groups: one launch on ``devconf.device()``, or one per data row of
a mesh (parallel/pipeline.py).
"""

from __future__ import annotations

import numpy as np
import torch

from paffy_tpu_torch import devconf, kernels, phases

NEG = -(1 << 62)      # "no candidate", as paffy_tpu's _NEG
K6_RECENT = 32        # K: the recent candidates the walker checks itself
K6_THREADS = 512      # a block: the walker warp and 15 helper warps
K6_MAX_RECENT = 256   # the ring of 2K+ slots stays within shared memory


def ring_slots(k: int) -> int:
    """Slots of the kernel's ring for ``k`` recent candidates: the least
    power of two above 2k (the walker reads records i - k .. i while the
    helpers fill them up to i + k)."""
    return 1 << (2 * k).bit_length()


def _best(val, te, qe, idx):
    """(val, te, qe, idx) of the largest key (val, te, qe, idx) of the
    candidates given (val NEG where there is none), by nested maxima as
    _dp_scan :61-67; (NEG, NEG, NEG, -1) without a candidate."""
    if not val.numel() or int(val.max()) == NEG:
        return NEG, NEG, NEG, -1
    tie = val == val.max()
    t = int(torch.where(tie, te, NEG).max())
    tie &= te == t
    q = int(torch.where(tie, qe, NEG).max())
    tie &= qe == q
    return int(val.max()), t, q, int(torch.where(tie, idx, -1).max())


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


def chain_dp_split_plain(goff, qs, ts, score, qe_s, te_s, idx_s, lo, w, pos,
                         gap_open: int, gap_extend: int, max_gap: int,
                         k: int = K6_RECENT):
    """Plain PyTorch emulation of the kernel's split: for each record i,
    the best old candidate (window slots whose record j < i - k, against
    the chain scores in query-end order) and the best recent one (j in
    [i - k, i), in the window iff lo[i] <= pos[j] < lo[i] + w[i]), merged
    by the key (val, te, qe, j).  Equals ``chain_dp_groups_plain``."""
    n = qs.numel()
    cs = score.clone()
    pred = torch.full((n,), -1, dtype=torch.int64, device=qs.device)
    cs_sorted = torch.full((n,), NEG, dtype=torch.int64, device=qs.device)
    lo_l, w_l, pos_l = lo.tolist(), w.tolist(), pos.tolist()
    qs_l, ts_l, sc_l = qs.tolist(), ts.tolist(), score.tolist()
    for i in range(n):
        a, b, s = lo_l[i], lo_l[i] + w_l[i], sc_l[i]

        def vals(slots, j):
            # the candidates' values (NEG where a test fails) and keys
            qe, te = qe_s[slots], te_s[slots]
            tgap = ts_l[i] - te
            gap = (qs_l[i] - qe) + tgap
            g = torch.where(gap == 0, 0, gap_open + gap_extend * gap)
            ok = (tgap >= 0) & (tgap <= max_gap) & (g < s)
            return torch.where(ok, s + cs_sorted[slots] - g, NEG), te, qe, j
        old = torch.arange(a, b, device=qs.device)
        old = old[idx_s[old] < i - k]
        recent = torch.arange(max(i - k, 0), i, device=qs.device)
        recent = recent[(pos[recent] >= a) & (pos[recent] < b)]
        best = max(_best(*vals(old, idx_s[old])),
                   _best(*vals(pos[recent], recent)))
        if best[3] >= 0 and best[0] > s:
            cs[i], pred[i] = best[0], best[3]
        cs_sorted[pos_l[i]] = cs[i]
    return cs, pred


def chain_dp_groups(goff, qs, ts, score, qe_s, te_s, idx_s, lo, w, pos,
                    gap_open: int, gap_extend: int, max_gap: int,
                    k: int = K6_RECENT, threads: int = K6_THREADS):
    """(cs, pred), int64 [n] in processing slots: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Every argument is a 1-D
    int64 tensor of n elements on one device, but ``goff`` (groups + 1).
    ``k`` (1..K6_MAX_RECENT) is the kernel's count of recent candidates,
    ``threads`` (64..512, a multiple of 32) its block size."""
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
    if not 1 <= k <= K6_MAX_RECENT or threads % 32 or \
            not 64 <= threads <= 512:
        raise ValueError(f"k must be in [1, {K6_MAX_RECENT}] and threads a "
                         f"multiple of 32 in [64, 512]; got {k}, {threads}")
    if qs.device.type == "cpu":
        return chain_dp_groups_plain(*args, gap_open, gap_extend, max_gap)
    dev = kernels.check_device(qs.device)
    cs = torch.empty(n, dtype=torch.int64, device=qs.device)
    pred = torch.empty_like(cs)
    if n == 0:
        return cs, pred
    cs_sorted = torch.empty_like(cs)      # scratch: cs in query-end order
    args = [x.contiguous() for x in args]
    rc = kernels.load().paffy_chain_dp(
        dev, goff.numel() - 1, *(x.data_ptr() for x in args), gap_open,
        gap_extend, max_gap, k, ring_slots(k), threads,
        cs_sorted.data_ptr(), cs.data_ptr(), pred.data_ptr(),
        kernels.stream_of(cs))
    kernels.check(rc, "chain_dp")
    kernels.count_launch("chain_dp")
    return cs, pred


def chain_groups_device(groups, gap_open: int, gap_extend: int, max_gap: int,
                        mesh=None):
    """The chain DP of ``groups``, a list of (qs, qe, ts, te, score) int64
    arrays in processing order: a list of (chain_score, pred) per group,
    pred a group-local index or -1, as _dp_numpy gives them.  Without a
    mesh, one K6 launch over all groups on ``devconf.device()``; with one,
    the groups are cut into ``data`` contiguous blocks of ceil(G / data)
    (where paffy_tpu's P("data") puts them) and each block is one launch on
    its row's first device.  The groups lie end to end, without padding."""
    from paffy_tpu_torch.ops.chain import dp_arguments   # it imports this
    if not groups:
        return []
    rows = ([devconf.device()] if mesh is None
            else [row[0] for row in mesh.devices])
    size = -(-len(groups) // len(rows))
    launched = []
    for dev, a in zip(rows, range(0, len(groups), size)):
        with phases.timed("window"):
            args = dp_arguments(groups[a: a + size], max_gap)
        with phases.timed("K6"):
            launched.append((args[0], *chain_dp_groups(
                *(devconf.upload(x, dev) for x in args), gap_open,
                gap_extend, max_gap)))
    out = []
    with phases.timed("K6"):      # ends with the readbacks
        for goff, cs, pred in launched:
            cs, pred = devconf.to_host_i64(cs), devconf.to_host_i64(pred)
            for a, b in zip(goff[:-1].tolist(), goff[1:].tolist()):
                out.append((cs[a:b], np.where(pred[a:b] >= 0, pred[a:b] - a,
                                              -1)))
    return out
