"""parse_s.deep: seconds per job in the PAF parse, the program's phase
"parse": parse_s.col's formula, loaded from its file."""

from genome_readings import reader


def read(run):
    return reader("parse_s.col").read(run)
