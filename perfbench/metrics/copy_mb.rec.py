"""copy_mb.rec: megabytes (1e6 bytes) per traced job across the link
between host and card: the counters "bytes_up" (devconf.upload: the pool,
the piece tables, K6's and K5's arguments) and "bytes_down" (the
readbacks: counts, the =/X cigar, chain scores, tile levels, K5's plan)
of every span."""

from program_spans import counted, per_traced_job


def read(run, spans=None):
    mb = per_traced_job(run, spans, counted("bytes_up", "bytes_down"))
    return None if mb is None else mb / 1e6
