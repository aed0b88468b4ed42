"""k1_roofline.view: K1 (csrc/piece_compare.cu, its walk in
csrc/piece_walk.cuh) as a share of its least time in ``view -s``: the
bytes the input asks of it at the card's HBM rate, over its device
seconds in the trace.  Bytes a launch, counted by the reference: the two
bytes of every M column read once, 25 for each M run's description
(query and target start and length, 8 bytes each, and its strand) and
16 for each record written (its two int64 counts, matches and
mismatches)."""

from readings import roofline


def least_s(w, pk):
    return ((2 * w["columns"] + 25 * w["m_runs"] + 16 * w["records"])
            / pk["hbm_bytes_per_s"])


def read(run):
    return roofline(run, ("piece_walk_kernel",), least_s)
