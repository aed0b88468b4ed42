"""parse_s.col: seconds per job in the PAF parse (commands.common,
core.pafio): the program's phase "parse"."""

from readings import per_job


def read(run):
    return per_job(run, ("parse",))
