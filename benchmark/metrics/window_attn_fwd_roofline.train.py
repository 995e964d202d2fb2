"""The window attention's share of its roofline in a training step: the
least time of every window-attention call of the step's forwards (the
teacher's TTA scales and the student; benchmark/counts/swin.py) over the
device time under the program's ``window_attn`` span in the profiled
steps. A program without the span reads nothing."""

from benchmark.counts.swin import window_attn_bound_s

SOURCE = "device_trace"
LAYER = "window attention"


def read(r):
    spent = r.trace.get("device_s", {}).get("window_attn", 0.0) / r.trace["units"]
    if spent <= 0:
        return None
    return 100.0 * window_attn_bound_s(r.config["config"], r.config["widths"]) / spent
