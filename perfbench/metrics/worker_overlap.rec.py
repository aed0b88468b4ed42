"""worker_overlap.rec: the program's phase seconds of the window's jobs,
summed over the worker threads ("K5 tiles" lies inside "K5" and is left
out), over the jobs' walls: how many workers are busy on average."""


def read(run):
    busy = sum(s for j in run.jobs for n, s in j.phases.items()
               if n != "K5 tiles")
    return busy / sum(j.wall for j in run.jobs)
