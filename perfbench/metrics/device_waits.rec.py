"""device_waits.rec: blocking waits on the card per traced job: the counter
"waits" of every span (a device phase's closing synchronize,
devconf.download, to_host_i64 and readback, K5's plan readbacks among
them)."""

from program_spans import counted, per_traced_job


def read(run, spans=None):
    return per_traced_job(run, spans, counted("waits"))
