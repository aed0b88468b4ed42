"""k5_roofline.deep: K5's walk and median (csrc/tile_sweep.cu) as a share of
their least time in the deep tile cell: 16 bytes an interval (a joined
stretch of aligned query bases: its start and end, as
reference_tile.intervals counts them) and 32 a record (its order, offset,
interval offset and level) at the card's HBM rate, over the two kernels'
device seconds in the trace.  The histogram rows, the counts carried
between batches and the plan are the implementation's, not the work's:
they are not in the least time."""

from readings import roofline


def least_s(w, pk):
    return (16 * w["intervals"] + 32 * w["records"]) / pk["hbm_bytes_per_s"]


def read(run):
    return roofline(run, ("tile_walk_kernel", "tile_median_kernel"), least_s)
