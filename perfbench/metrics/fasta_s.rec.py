"""fasta_s.rec: seconds per traced job in the FASTA read and the pool
(core.fasta, ops.mismatch.SequencePool, K2), from inside the program: its
phases "fasta" (SequencePool.from_fasta_files), "pool upload" and "K2"."""

from program_spans import per_traced_job, phase_s


def read(run, spans=None):
    return per_traced_job(run, spans, phase_s("fasta", "pool upload", "K2"))
