"""write_s.deep: seconds per job in the output, the program's phases
"serialize" and "write": write_s.col's formula, loaded from its file."""

from genome_readings import reader


def read(run):
    return reader("write_s.col").read(run)
