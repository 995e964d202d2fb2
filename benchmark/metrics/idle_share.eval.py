"""The share of a validation batch in which the card runs nothing: one
less the device's busy time per profiled batch (each profiled call scores
``trace_images`` images) over the untraced window's mean time per batch of
``eval_batch`` images."""

SOURCE = "device_trace"
LAYER = "device"


def read(r):
    batch = r.config["config"]["eval_batch"]
    busy = r.trace.get("busy_s", 0.0) / (r.trace["units"] * r.traffic["trace_images"] / batch)
    if busy <= 0:
        return None
    batches = r.window["images"] / batch
    return 100.0 * (1.0 - busy / (r.window["seconds"] / batches))
