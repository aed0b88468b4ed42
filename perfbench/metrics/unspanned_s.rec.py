"""unspanned_s.rec: seconds per traced job in no phase of the program: the
job's wall minus the union of its phase spans over every thread (the
benchmark's own calls, the output's hash, what no phase covers)."""

from program_spans import per_traced_job, unspanned


def read(run, spans=None):
    return per_traced_job(run, spans, unspanned)
