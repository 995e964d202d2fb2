#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, in one
process over many seeds (benchmark/workloads/<cell>.json keeps them):

* ``program``: the program's sound runs, the numbers a run of
  benchmark/run.py compares, without the measured window;
* ``control``: the plain reference computed with its products' operands in
  float8 (reference/model.py), put in the program's place;
* ``half_loss`` and ``flipped_update`` (training): the reference put in the
  program's place with a fault planted (reference/cosa.py's ``FAULTS``):
  the losses taken over half of each batch with the forward whole, and
  each update applied the wrong way.

    python3 benchmark/control.py --workload voc.train_staged --seeds 11 12 13 \\
        [--program 1] [--control 1]

Prints one JSON line per seed and reading. It runs on the card, at the
cell's own sizes; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
if sys.path[0] != str(ROOT):
    sys.path[0] = str(ROOT)
# torch is imported inside the functions, as in benchmark/run.py


def readings(workload: str, seeds: List[int], program: bool, control: bool,
             device: str = "cuda", overrides: Optional[Dict] = None) -> List[Dict]:
    import torch

    from benchmark import harness
    from benchmark.run import Context, _merge

    cell = harness.find_cell(workload)
    for key, over in (overrides or {}).items():
        setattr(cell, key, _merge(getattr(cell, key), over))
    cell.traffic = dict(cell.traffic, warmup_steps=0)
    generator = cell.generator
    dev = torch.device(device)
    out = []
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="cosa_bench_") as tmp:
            ctx = Context(cell, seed, dev, tmp)
            if program:
                wl = generator.build(ctx)
                wl.call()  # one call of the window's path (validation records in it)
                out.append(dict(seed=seed, reading="program", **wl.check()))
                del wl
            if control:
                out += [dict(seed=seed, reading=k, **v)
                        for k, v in generator.control_numbers(ctx).items()]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    harness.set_environment(ROOT)
    for r in readings(args.workload, args.seeds, bool(args.program), bool(args.control)):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
