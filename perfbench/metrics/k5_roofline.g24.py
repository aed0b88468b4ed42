"""k5_roofline.g24: K5's walk and median (csrc/tile_sweep.cu) as a share of
their least time in the genome cell, one sweep a contig group on four
worker streams: the least time of a launch is k5_roofline.rec's
``least_s``, loaded from its file, over the two kernels' device seconds
in the trace (its plan not among them)."""

from genome_readings import reader
from readings import roofline


def read(run):
    return roofline(run, ("tile_walk_kernel", "tile_median_kernel"),
                    reader("k5_roofline.rec").least_s)
