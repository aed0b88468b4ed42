"""runner_s.g24: seconds per traced job in run_pipeline's own work around
the stage (parallel.runner) on the genome's contig groups, summed over
the worker threads: runner_s.rec's reading (the program's phases
"split", "gather" and "concat"), in the genome cell."""

from genome_readings import reader


def read(run, spans=None):
    return reader("runner_s.rec").read(run, spans)
