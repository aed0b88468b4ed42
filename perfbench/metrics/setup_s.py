"""setup_s: from the process's start to the window's start: imports, the
kernel library, the inputs made from the seed and written, the traffic's
set-up and its warm jobs."""


def read(run):
    return run.setup_s
