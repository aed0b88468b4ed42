"""device_idle.g1w: the share of the traced window in which no kernel, copy or
memset ran on the card, in %, with the runner's one worker:
device_idle.g24's formula, loaded from its file."""

from genome_readings import reader


def read(run):
    return reader("device_idle.g24").read(run)
