"""A/B bench: the dense-energy filter on the training path, the calibrated
RFF surrogate (the default) against the exact permutohedral lattice.

The port's counterpart of scripts/bench_lattice.py. Each filter's full VOC
step (ViT-B/16, crop 448, global batch 4) is timed by cli/bench.py's
harness and prints one line with that script's keys under the metric
``voc_train_step_energy_<filter>``. The JAX package builds the lattice in
a program of its own before each step (its train loop's ``lat_fn``); the
port builds it inside ``objectives/energy.py::get_energy_loss``, in the
step's ``energy`` span, so the lattice line's timed step holds the build
by construction (ROADMAP, deliberate differences). The lattice line
launches no K3.

    python -m cosa_tpu_torch.cli.bench_lattice [--iters 20]
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

FILTERS = ("rff", "lattice")


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    add_model_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    info = device_info(dev)
    lines = []
    for kind in FILTERS:
        cfg = voc_config(batch_size=4, energy_filter=kind, energy_convention=1.0,
                         **model_overrides(args))
        res = bench_step(cfg, 4, dev, args.iters)
        lines.append(emit(step_line(f"voc_train_step_energy_{kind}", res, res["secs"][0], 4,
                                    dev, info, VOC_BASELINE_IMGS_PER_SEC)))
    return lines


if __name__ == "__main__":
    main()
