"""The attention backward's share of its roofline in a training step: the
least time of the student's attention backward in every layer
(benchmark/counts/), over the device time of the kernels that run it in
the profiled steps: K2's four (pre, delta, main, post) of
csrc/flash_attn.cu, found by the name pattern below."""

from benchmark.counts import attention_bound_s, train_step_calls
from benchmark.frozen.trace import kernel_seconds

SOURCE = "device_trace"
LAYER = "attention kernels"
KERNELS = ("attn_bwd",)


def read(r):
    spent = kernel_seconds(r.trace, KERNELS) / r.trace["units"]
    if spent <= 0:
        return None
    bound = attention_bound_s(r.config["widths"], train_step_calls(r.config["config"]), True)
    return 100.0 * bound / spent
