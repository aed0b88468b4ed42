"""k5_plan_s.g24: seconds per job in K5's plan (ops/tile_device.tile_plan,
the program's phase "K5 tiles"), summed over the worker threads that run
it at once."""

from readings import per_job


def read(run):
    return per_job(run, ("K5 tiles",))
