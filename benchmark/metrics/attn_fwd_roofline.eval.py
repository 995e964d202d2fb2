"""The attention forwards' share of their roofline in validation: the
least time of every layer's attention forward at the five eval scales x
flip of each profiled image (benchmark/counts/; each profiled call scores
``trace_images``), over the device time of the kernels that run them (K1,
found by the name pattern below)."""

from benchmark.counts import attention_bound_s, eval_image_calls
from benchmark.frozen.trace import kernel_seconds

SOURCE = "device_trace"
LAYER = "attention kernels"
KERNELS = ("attn_fwd_kernel",)


def read(r):
    spent = kernel_seconds(r.trace, KERNELS)
    if spent <= 0:
        return None
    images = r.trace["units"] * r.traffic["trace_images"]
    bound = attention_bound_s(r.config["widths"], eval_image_calls(r.config["config"]), False)
    return 100.0 * bound * images / spent
