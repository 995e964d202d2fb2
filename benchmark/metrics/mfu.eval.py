"""The whole validation's share of the card's dense bf16 peak: the model
FLOPs of each scored image's eval scales x flip forwards
(benchmark/counts/) times the untraced window's images, over its seconds."""

from benchmark.counts import eval_image_flops
from benchmark.frozen.peaks import PEAK_BF16_FLOPS

SOURCE = "host_clock"
LAYER = "eval engine"


def read(r):
    flops = eval_image_flops(r.config["config"], r.config["widths"]) * r.window["images"]
    return 100.0 * flops / r.window["seconds"] / PEAK_BF16_FLOPS
