"""k5_carried_mb.deep: MB of counts K5 carries between its batches per
traced job: the counter "carried_mb" of the plan's span "K5 tiles", 4
bytes (2 stored, 2 loaded) a position of each tile whose counts a batch
takes from the batch before; 0 with one batch."""

from deep_readings import plan_counter


def read(run, spans=None):
    return plan_counter(run, "carried_mb", spans)
