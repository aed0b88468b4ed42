"""k5_batches.deep: K5's launch pairs (walk and median) per traced job: the
counter "batches" of the plan's span "K5 tiles", one batch of histogram
rows each (ops/tile_device.tile_plan)."""

from deep_readings import plan_counter


def read(run, spans=None):
    return plan_counter(run, "batches", spans)
