"""drain_s.g24: seconds per traced job in which run_pipeline's workers run
dry: from the end of the last contig group on the first worker thread to
run out of groups to the end of the last group (the program's "group"
spans by thread, and the "workers" counter of its "run_pipeline" span,
so that a worker that ran no group is idle from the first group's
start)."""

from genome_readings import drain_s, per_traced_call


def read(run, spans=None):
    return per_traced_call(run, spans, drain_s)
