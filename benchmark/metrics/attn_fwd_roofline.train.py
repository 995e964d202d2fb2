"""The attention forwards' share of their roofline in a training step:
the least time of every layer's attention forward that the step needs
(the teacher's TTA scales and the student; benchmark/counts/), over the
device time of the kernels that run them in the profiled steps, found by
the name patterns below (K1 of kernels/flash.py, csrc/flash_attn.cu)."""

from benchmark.counts import attention_bound_s, train_step_calls
from benchmark.frozen.trace import kernel_seconds

SOURCE = "device_trace"
LAYER = "attention kernels"
KERNELS = ("attn_fwd_kernel",)


def read(r):
    spent = kernel_seconds(r.trace, KERNELS) / r.trace["units"]
    if spent <= 0:
        return None
    bound = attention_bound_s(r.config["widths"], train_step_calls(r.config["config"]), False)
    return 100.0 * bound / spent
