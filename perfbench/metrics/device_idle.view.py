"""device_idle.view: the share of the traced window in which no kernel,
copy or memset ran on the card, in %."""

from readings import idle_share


def read(run):
    return idle_share(run)
