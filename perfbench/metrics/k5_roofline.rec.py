"""k5_roofline.rec: K5's walk and median (csrc/tile_sweep.cu) as a share of
their least time: 16 bytes an interval (each =/X run's query start and
end) and 32 a record (its order, offset, run offset and level) at the
card's HBM rate, over the two kernels' device seconds in the trace.  The
plan (ops/tile_device.tile_plan) runs as PyTorch's own kernels, whose
names the trace does not tie to K5: they are not in the device time."""

from readings import roofline


def least_s(w, pk):
    return (16 * w["eqx_runs"] + 32 * w["records"]) / pk["hbm_bytes_per_s"]


def read(run):
    return roofline(run, ("tile_walk_kernel", "tile_median_kernel"), least_s)
