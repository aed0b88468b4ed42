"""write_s.col: seconds per job in the output (the serializer and
commands.common.GlibcWriter): the program's phases "serialize" and
"write"."""

from readings import per_job


def read(run):
    return per_job(run, ("serialize", "write"))
