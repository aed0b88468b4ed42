"""tile_s.deep: seconds per job in the tile, the program's phases "order",
"intervals" and "K5" (which holds "K5 tiles"): tile_s.rec's formula, loaded
from its file."""

from genome_readings import reader


def read(run):
    return reader("tile_s.rec").read(run)
