"""device_wait_s.col: host seconds per traced job blocked on the card: the
counter "wait_s" of every span (a device phase's closing synchronize,
devconf.download, to_host_i64 and readback)."""

from program_spans import counted, per_traced_job


def read(run, spans=None):
    return per_traced_job(run, spans, counted("wait_s"))
