"""Run one preset of cli/run_synth.py with its work directory on a tmpfs,
copy the run's logs out, and summarise its step time.

Usage:
  python -m cosa_tpu_torch.cli.chip_run PRESET [NAME] --work_dir /dev/shm/wd \
      --out DIR [flags...]

A validation writes a full checkpoint (student, teacher and the two AdamW
moments, about 1.5 GB at ViT-B) and a winning network its best weights
(about 0.36 GB); a 10k-iteration run with 20 validations writes 30-43 GB.
On a tmpfs, ``checkpoint_keep=2`` keeps 3-4 GB of it resident, so the
work directory must be one (checked against /proc/mounts) with at least
8 GB free. After the run (or its failure) ``metrics.jsonl``, ``log_val.txt``,
``print.out`` and each ``best_*/meta.json`` go to ``--out``, and the loop's
sec/iter is summarised: the median and quartiles of the logged windows'
``itertime`` after the first (which holds the set-up; the loop leaves the
validations out of every window), and the wall times. Other flags go to
run_synth.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from typing import Dict, List

MIN_FREE = 8e9  # two checkpoints, two best-weights files, and a spare one


def mount_of(path: str):
    """(mount point, filesystem type) holding ``path``, from /proc/mounts."""
    path = os.path.realpath(path)
    best = ("", "")
    with open("/proc/mounts") as f:
        for line in f:
            _, point, fstype = line.split()[:3]
            inside = path == point or path.startswith(point.rstrip("/") + "/")
            if inside and len(point) > len(best[0]):
                best = (point, fstype)
    return best


def itertime_stats(records: List[Dict]) -> Dict:
    """The step time of a run's ``kind == "train"`` records: each window's
    ``itertime`` (seconds per iteration) after the first."""
    times = [r["itertime"] for r in records if r.get("kind") == "train"][1:]
    q1, med, q3 = statistics.quantiles(times, n=4) if len(times) > 1 else times * 3
    return dict(windows=len(times), median=med, q1=q1, q3=q3, min=min(times),
                max=max(times), iqr_over_median=(q3 - q1) / med)


def summarise(out_dir: str) -> Dict:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    train = [r for r in recs if r.get("kind") == "train"]
    vals = [r for r in recs if r.get("kind") == "val"]
    best = lambda k: max((r[k] for r in vals), default=float("nan"))
    final = [r for r in recs if r.get("kind") == "final"]
    with open(os.path.join(out_dir, "print.out")) as f:
        conv = [ln.strip() for ln in f if ln.startswith("energy convention auto-calibrated")]
    return dict(energy_convention=conv[0] if conv else None,
                sec_per_iter=itertime_stats(recs), iters=train[-1]["iter"] if train else 0,
                train_wall_s=train[-1]["wall_s"] if train else None,
                validations=len(vals) // 2, best_seg_vd=best("Seg_vd"), best_cam=best("CAM"),
                final={k: v for k, v in final[-1].items() if k != "kind"} if final else None)


def main(argv=None) -> int:
    from cosa_tpu_torch.cli import run_synth, train
    from cosa_tpu_torch.config import parse_cli

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--work_dir", required=True)
    ap.add_argument("--out", required=True)
    ns, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    rest += ["--work_dir", ns.work_dir]
    _, args = run_synth.parse(rest)
    cfg = parse_cli(train.split_device(args)[1])
    run_dir, out = os.path.join(ns.work_dir, cfg.name), ns.out
    os.makedirs(ns.work_dir, exist_ok=True)
    point, fstype = mount_of(ns.work_dir)
    free = shutil.disk_usage(ns.work_dir).free
    print(f"work_dir {ns.work_dir}: {fstype} at {point}, {free / 1e9:.1f} GB free", flush=True)
    if fstype != "tmpfs" or free < MIN_FREE:
        raise SystemExit(f"chip_run: --work_dir must be on a tmpfs with {MIN_FREE / 1e9:.0f} GB "
                         f"free; {ns.work_dir} is on {fstype} with {free / 1e9:.1f} GB")
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    except FileNotFoundError:
        card = "no nvidia-smi"
    print(f"card: {card}", flush=True)
    t0 = time.time()
    try:
        run_synth.main(rest)
    finally:
        wall = time.time() - t0
        os.makedirs(out, exist_ok=True)
        for f in ("metrics.jsonl", "log_val.txt", "print.out"):
            if os.path.exists(os.path.join(run_dir, f)):
                shutil.copy(os.path.join(run_dir, f), out)
        for kind in ("seg", "cam"):
            meta = os.path.join(run_dir, f"best_{kind}", "meta.json")
            if os.path.exists(meta):
                shutil.copy(meta, os.path.join(out, f"best_{kind}_meta.json"))
        print(f"chip_run: {wall:.1f} s for the command; logs in {out}", flush=True)
    summary = dict(preset=rest[0], name=cfg.name, command_wall_s=round(wall, 1),
                   card=card, **summarise(run_dir))
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
