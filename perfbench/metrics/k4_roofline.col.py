"""k4_roofline.col: K4's count and fill (csrc/encode_runs.cu) as a share of
their least time: the bytes the input asks of them at the card's HBM
rate, over their device seconds in the trace.  Bytes a launch: the two
bytes of every M column read once, 25 for each M run's description
(query and target start and length, 8 bytes each, and its strand) and 9
for each =/X run written (its op and its 8-byte length)."""

from readings import roofline


def least_s(w, pk):
    return ((2 * w["columns"] + 25 * w["m_runs"] + 9 * w["eqx_runs"])
            / pk["hbm_bytes_per_s"])


def read(run):
    return roofline(run, ("encode_runs_kernel",), least_s)
