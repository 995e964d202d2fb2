"""Device milliseconds per training step under the program's
``window_attn`` span (models/zoo/swin.py::WindowAttention: the scores, the
bias, the mask, the softmax and the product with v of every Swin block in
the teacher's TTA and the student's forward), from the profiled steps. A
program without the span reads nothing."""

SOURCE = "program_span"
LAYER = "window attention"


def read(r):
    ms = r.trace.get("device_s", {}).get("window_attn", 0.0) * 1e3 / r.trace["units"]
    return ms if ms > 0 else None
