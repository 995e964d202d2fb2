"""Seconds from the process's start to the first timed call: imports, the
inputs, the program's state, the checked steps and the warm-up (and, in a
checkout's first run, the kernels' builds)."""

SOURCE = "host_clock"


def read(r):
    return r.setup_s
