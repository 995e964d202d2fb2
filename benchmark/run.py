#!/usr/bin/env python3
"""The benchmark of cosa_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): the cell's
generator builds the program's state from the benchmark's seeded weights and
inputs, drives it through the steps the check compares, and warms up every
shape the window uses. The window then calls the generator for ``--seconds``
and ends in a device synchronisation. With ``--trace 1`` the same window
is measured, then a short fixed number of calls is profiled, and the line
carries the cell's per-layer metrics instead of its end-to-end ones. After
the window the program's state is freed and the plain reference
(benchmark/reference/) checks what the window's path produced.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` (traced
runs) and last ``checks``, each number compared beside its limit; the
same numbers end standard error. Without a CUDA card holding the cell's
chips the command exits 2 and prints no result; it exits 3 if a module of
JAX or of the JAX package is loaded when the window has closed.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
if sys.path[0] != str(ROOT):
    sys.path[0] = str(ROOT)  # the checkout, not benchmark/, so that `benchmark` is a package
# torch and the harness are imported inside the functions: the tree writer's
# spawned workers import this module, and need neither


class Context:
    """What a traffic generator is given: the cell's files (with a test's
    overrides merged in), the seed, the device and a scratch directory."""

    def __init__(self, cell, seed: int, device, tmpdir: str, start: float = 0.0):
        from benchmark import harness

        self.cell = cell
        self.setup_marks = harness.SetupMarks(start or time.time(), device)
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.device = device
        self.tmpdir = tmpdir

    def port_config(self, **extra):
        """The program's Config of this cell: its preset with the
        configuration file's settings (lists as tuples)."""
        from cosa_tpu_torch.config import preset_config

        c = {k: tuple(v) if isinstance(v, list) else v for k, v in self.config["config"].items()}
        c.update(extra)
        return preset_config(c.pop("dataset"), **c)


def _merge(base: Dict, over: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[Dict] = None, root: Path = ROOT) -> Dict:
    """One run (module docstring); returns the result line as a dict. A run
    on the CPU (a rehearsal at a test's small ``overrides``) reports no
    device metric."""
    import torch

    from benchmark import harness

    t_start = harness.process_start()
    cell = harness.find_cell(workload, root)
    for key, over in (overrides or {}).items():
        setattr(cell, key, _merge(getattr(cell, key), over))
    dev = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="cosa_bench_") as tmp:
        ctx = Context(cell, seed, dev, tmp, t_start)
        ctx.setup_marks.mark("imports")
        wl = cell.generator.build(ctx)
        harness.sync(dev)
        setup_s = time.time() - t_start
        window = harness.measure(wl.call, seconds, dev)
        info = harness.device_info(dev, cell.chips)
        line: Dict = dict(correct=False, attempted=wl.attempted(window), failed=0)
        red: Dict = {}
        if trace:
            red = harness.profile(wl.trace_call, wl.trace_units, dev, wl.spans)
            if dev.type == "cuda":
                info.update(busy_s=red.get("busy_s", 0.0), window_s=red.get("window_s", 0.0))
        reading = harness.Reading(cell.config, cell.traffic, window, red, setup_s,
                                  info["memory_peak_bytes"])
        metrics = harness.read_metrics(cell, cell.per_layer if trace else cell.end_to_end,
                                       reading)
        if dev.type != "cuda":
            metrics = {}  # read all the same, so that a rehearsal finds every reader
        numbers = wl.check()
        line.update(correct=harness.judge(numbers, cell.limits), metrics=metrics, device=info)
        if trace and dev.type == "cuda":
            line["breakdown"] = dict(device_ops=red.get("device_ops", []),
                                     idle_gaps=red.get("idle_gaps", []))
        line["checks"] = {k: dict(value=numbers.get(k), limit=lim)
                          for k, lim in cell.limits.items()}
        line["numbers"] = numbers
        line["setup"] = ctx.setup_marks.phases
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    chips = harness.find_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s), this machine has "
              f"{have}; no result", file=sys.stderr)
        return 2
    harness.set_environment(ROOT)
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules {bad} are loaded after the window; no result",
              file=sys.stderr)
        return 3
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in line.pop("setup")), file=sys.stderr)
    for k, v in line.pop("numbers").items():
        if k not in line["checks"]:
            print(f"reading {k} {v}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
