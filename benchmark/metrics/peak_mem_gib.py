"""``torch.cuda.max_memory_allocated()`` after the window, before the check."""

SOURCE = "host_clock"


def read(r):
    return r.peak_bytes / 2 ** 30
