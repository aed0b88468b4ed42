"""pool_s.rec: seconds per job building the pool from the FASTA: the
benchmark's span "pool" around SequencePool.from_fasta_files, plus the
program's phase "K2"."""

from readings import per_job


def read(run):
    if not any("pool" in j.spans for j in run.jobs):
        return None
    return per_job(run, ("K2",), ("pool",))
