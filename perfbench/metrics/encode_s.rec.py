"""encode_s.rec: seconds per job in the encode, summed over the worker
threads: the program's phases "batch", "pieces", "upload" (the tile's
upload shares this name and is counted here), "K4 count", "rebuild",
"K4 fill" and "download"."""

from readings import per_job

ENCODE = ("batch", "pieces", "upload", "K4 count", "rebuild", "K4 fill",
          "download")


def read(run):
    return per_job(run, ENCODE)
