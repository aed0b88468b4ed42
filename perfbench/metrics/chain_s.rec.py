"""chain_s.rec: seconds per job in the chain (ops.chain, ops.chain_device),
summed over the worker threads: the program's phases "window", "K6" and
"extract"."""

from readings import per_job


def read(run):
    return per_job(run, ("window", "K6", "extract"))
