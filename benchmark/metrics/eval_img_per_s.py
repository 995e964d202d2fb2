"""Images scored by whole validation passes in the measured window over its
seconds (the window ends in a device synchronisation)."""

SOURCE = "host_clock"


def read(r):
    return r.window["images"] / r.window["seconds"]
