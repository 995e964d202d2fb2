"""The share of a training step in which the card runs nothing: one less
the device's busy time per profiled step (the union of its kernel, copy
and memset intervals) over the untraced window's mean step time. The
tracer slows the host, not the kernels, so the busy time is read under it
and the step time without it."""

SOURCE = "device_trace"
LAYER = "device"


def read(r):
    busy = r.trace.get("busy_s", 0.0) / r.trace["units"]
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (r.window["seconds"] / r.window["calls"]))
