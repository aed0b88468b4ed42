"""k5_plan_s.g1w: seconds per job in K5's plan, the program's phase "K5
tiles", with the runner's one worker: k5_plan_s.g24's formula, loaded from
its file."""

from genome_readings import reader


def read(run):
    return reader("k5_plan_s.g24").read(run)
