"""Device milliseconds per training step under the program's
``teacher_tta`` span (train/step.py): the EMA teacher's multi-scale x flip
TTA, from the profiled steps."""

SOURCE = "program_span"
LAYER = "train step"


def read(r):
    ms = r.trace.get("device_s", {}).get("teacher_tta", 0.0) * 1e3 / r.trace["units"]
    return ms if ms > 0 else None
