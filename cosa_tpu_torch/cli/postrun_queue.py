"""The measurement queue: the card's tests and every benchmark twin, in
order, each in a subprocess with its own time limit.

The port's counterpart of scripts/postrun_queue.sh. The steps:

  tree           bench_e2e.py's 96-image VOC-layout JPEG tree, written
                 under --out for bench_loader
  cuda_tests     python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
  bench_lattice  cli/bench_lattice.py (RFF against the lattice energy)
  bench_scales   cli/bench_scales.py (3, 2 and 1 teacher TTA scales)
  bench          cli/bench.py --repeats 3 (VOC with its quartiles, lattice, COCO)
  bench_loader   cli/bench_loader.py on the tree (threads and processes)
  bench_e2e      cli/bench_e2e.py (JPEGs through the loader into the step)
  profile_step   cli/profile_step.py (the pieces and the spans; its trace
                 goes to --out/profile_trace.json.gz)

Each step's standard output goes to ``--out/NAME.json`` (the JSON lines of
a twin) or ``--out/NAME.log`` (the tree and the tests), its standard error
to ``--out/NAME.log``. Like the shell script it goes on past a failed step;
unlike it, it exits nonzero when any step failed (a step cut at its limit
reads rc 124), and its last line lists every step's rc and seconds.

    python -m cosa_tpu_torch.cli.postrun_queue --out DIR
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Step(NamedTuple):
    name: str
    argv: List[str]
    timeout_s: float
    json_lines: bool  # its standard output is JSON lines (else a log)


def default_steps(out: str) -> List[Step]:
    py = sys.executable
    tree = os.path.join(out, "tree")

    def twin(name, *args, timeout_s=900):
        return Step(name, [py, "-m", f"cosa_tpu_torch.cli.{name}", *args], timeout_s, True)

    return [
        Step("tree", [py, "-c", "from cosa_tpu_torch.cli.bench_e2e import build_tree; "
                                f"build_tree({tree!r}, 'voc')"], 300, False),
        Step("cuda_tests", [py, "-m", "pytest", "--noconftest", "-m", "cuda",
                            "tests/test_torch_cuda.py", "-q", "-p", "no:cacheprovider"],
             1200, False),
        twin("bench_lattice"),
        twin("bench_scales"),
        twin("bench", "--repeats", "3", timeout_s=1200),
        twin("bench_loader", "--data_root", tree),
        twin("bench_e2e"),
        twin("profile_step", "--out", os.path.join(out, "profile_trace.json.gz")),
    ]


def run_queue(steps: List[Step], out: str) -> List[Dict]:
    """Run ``steps`` in order from the checkout's root; one record each."""
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    results = []
    for s in steps:
        print(f"=== {s.name}: {' '.join(s.argv)}", flush=True)
        t0 = time.perf_counter()
        with open(os.path.join(out, s.name + ".log"), "w") as log, \
                (open(os.path.join(out, s.name + ".json"), "w") if s.json_lines
                 else contextlib.nullcontext(log)) as std:
            proc = subprocess.Popen(s.argv, cwd=ROOT, env=env, stdout=std, stderr=log)
            try:
                rc = proc.wait(timeout=s.timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = 124
        results.append(dict(step=s.name, rc=rc, seconds=time.perf_counter() - t0))
        print(json.dumps(results[-1]), flush=True)
    return results


def main(argv=None, steps=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    results = run_queue(default_steps(out) if steps is None else steps, out)
    failed = [r["step"] for r in results if r["rc"] != 0]
    print(json.dumps({"postrun": results, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
