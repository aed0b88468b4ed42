"""device_idle.deep: the share of the traced window in which no kernel, copy
or memset ran on the card, in %: device_idle.g24's formula, loaded from its
file."""

from genome_readings import reader


def read(run):
    return reader("device_idle.g24").read(run)
