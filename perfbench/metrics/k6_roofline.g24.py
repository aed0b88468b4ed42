"""k6_roofline.g24: K6 (csrc/chain_dp.cu) as a share of its least time in
the genome cell, one launch a contig group on four worker streams: the
least time of a launch is k6_roofline.rec's ``least_s``, loaded from its
file, over K6's device seconds in the trace."""

from genome_readings import reader
from readings import roofline


def read(run):
    return roofline(run, ("chain_dp_kernel",),
                    reader("k6_roofline.rec").least_s)
