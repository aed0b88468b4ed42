"""encode_s.col: seconds per job in the encode (ops.segments, ops.compare,
ops.runs, ops.mismatch): the program's phases "batch", "pieces",
"upload", "K4 count", "rebuild", "K4 fill" and "download"."""

from readings import per_job

ENCODE = ("batch", "pieces", "upload", "K4 count", "rebuild", "K4 fill",
          "download")


def read(run):
    return per_job(run, ENCODE)
