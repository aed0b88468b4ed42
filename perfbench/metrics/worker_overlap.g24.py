"""worker_overlap.g24: how many of run_pipeline's workers are busy on
average over the window's jobs: worker_overlap.rec's formula (the
program's phase seconds, summed over the worker threads, over the jobs'
walls), read in the genome cell."""

from genome_readings import reader


def read(run):
    return reader("worker_overlap.rec").read(run)
