"""The Swin training step's share of the card's dense bf16 peak: the model
FLOPs a step requires (benchmark/counts/swin.py, from the configuration's
shapes) times the untraced window's steps, over the window's seconds."""

from benchmark.counts.swin import train_step_flops
from benchmark.frozen.peaks import PEAK_BF16_FLOPS

SOURCE = "host_clock"
LAYER = "train step"


def read(r):
    flops = train_step_flops(r.config["config"], r.config["widths"]) * r.window["calls"]
    return 100.0 * flops / r.window["seconds"] / PEAK_BF16_FLOPS
