"""The whole training step's share of the card's dense bf16 peak: the
model FLOPs a step requires (benchmark/counts/, from the configuration's
shapes) times the untraced window's steps, over the window's seconds."""

from benchmark.counts import train_step_flops
from benchmark.frozen.peaks import PEAK_BF16_FLOPS

SOURCE = "host_clock"
LAYER = "train step"


def read(r):
    c = r.config["config"]
    flops = train_step_flops(c, r.config["widths"]) * r.window["calls"]
    return 100.0 * flops / r.window["seconds"] / PEAK_BF16_FLOPS
