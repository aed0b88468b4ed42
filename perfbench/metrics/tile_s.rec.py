"""tile_s.rec: seconds per job in the tile (ops.tile, ops.tile_device),
summed over the worker threads: the program's phases "order",
"intervals" and "K5" (which holds "K5 tiles", the plan)."""

from readings import per_job


def read(run):
    return per_job(run, ("order", "intervals", "K5"))
