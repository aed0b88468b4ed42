"""k5_hist_mb.deep: MB of K5's histogram rows per traced job, over all its
batches: the counter "hist_mb" of the plan's span "K5 tiles", 4 bytes a
bin (ops/tile_device.tile_plan's n_bins)."""

from deep_readings import plan_counter


def read(run, spans=None):
    return plan_counter(run, "hist_mb", spans)
