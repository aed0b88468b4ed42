"""columns_per_s: the input's M columns of every job of the window over the
window's seconds (its start to the last job's end)."""

from readings import work_total


def read(run):
    return work_total(run, "columns") / run.window_s
