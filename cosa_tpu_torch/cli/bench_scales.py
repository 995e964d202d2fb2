"""A/B bench: the teacher TTA's scale count on the training path.

The port's counterpart of scripts/bench_scales.py. The reference's
``pseudo_scales=(1.0, 0.5, 1.5)`` (args.py:53) is the parity default; the
opt-in (1.0, 0.5) and (1.0,) trade strict parity for step time. Each
variant's full VOC step (ViT-B/16, crop 448, global batch 4) is timed by
cli/bench.py's harness, and each prints one line with that script's keys
under the metric ``voc_train_step_scales_<scales>``. K1 runs 12 times per
teacher scale and 12 in the student: 48, 36 and 24 launches per step.

    python -m cosa_tpu_torch.cli.bench_scales [--iters 20]
"""

from __future__ import annotations

import argparse
from typing import Dict, List

from cosa_tpu_torch.cli.bench import (
    VOC_BASELINE_IMGS_PER_SEC,
    add_model_args,
    bench_step,
    device_info,
    emit,
    model_overrides,
    step_line,
)
from cosa_tpu_torch.config import voc_config
from cosa_tpu_torch.utils.device import resolve_device

SCALES = ((1.0, 0.5, 1.5), (1.0, 0.5), (1.0,))


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    add_model_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    info = device_info(dev)
    lines = []
    for scales in SCALES:
        cfg = voc_config(batch_size=4, pseudo_scales=scales, energy_convention=1.0,
                         **model_overrides(args))
        res = bench_step(cfg, 4, dev, args.iters)
        name = "voc_train_step_scales_" + "x".join(str(x) for x in scales)
        lines.append(emit(dict(step_line(name, res, res["secs"][0], 4, dev, info,
                                         VOC_BASELINE_IMGS_PER_SEC), pseudo_scales=list(scales))))
    return lines


if __name__ == "__main__":
    main()
