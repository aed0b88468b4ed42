"""fasta_s.col: seconds per job in the FASTA read and the pool (core.fasta,
ops.mismatch.SequencePool, K2): the program's phases "fasta", "pool
upload" and "K2"."""

from readings import per_job


def read(run):
    return per_job(run, ("fasta", "pool upload", "K2"))
