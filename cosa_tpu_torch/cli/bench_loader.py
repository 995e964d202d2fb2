"""Input-pipeline scaling: decode + augment throughput against the worker
count, thread pool against process pool.

The port's counterpart of scripts/bench_loader.py. It runs
data/loader.py::TrainLoader (JPEG decode, rescale, flip, crop, blur,
RandAug) over a VOC-layout tree with no device work at all, so the numbers
are the host pipeline's alone. A negative worker count selects the
process pool (data/loader.py). Each setting prints one JSON line:
``workers``, ``pool``, ``imgs_per_sec``, ``sec_per_batch``,
``batch_size``, ``n_batches``, ``host_cores`` (the cores this process may
run on) and ``device`` ("cpu": the host does all of it).

    python -m cosa_tpu_torch.cli.bench_loader --data_root DIR \\
        [--split_dir DIR/splits] [--workers 1 2 4 8 -2 -4]

cli/bench_e2e.py::build_tree writes such a tree.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

from cosa_tpu_torch.cli.bench import emit
from cosa_tpu_torch.config import voc_config
from cosa_tpu_torch.data.loader import TrainLoader, build_train_dataset

WARMUP = 3  # batches before the timed ones


def host_cores() -> int:
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--split_dir", default="")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--n_batches", type=int, default=30)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 2, 4, 8, -2, -4])
    args = ap.parse_args(argv)
    cfg = voc_config(data_root=args.data_root,
                     split_dir=args.split_dir or os.path.join(args.data_root, "splits"))
    lines = []
    for w in args.workers:
        loader = TrainLoader(build_train_dataset(cfg), batch_size=args.batch_size, seed=0,
                             num_workers=w, process_index=0, process_count=1)
        try:
            for _ in range(WARMUP):  # pool spin-up, first-touch caches
                next(loader)
            t0 = time.perf_counter()
            for _ in range(args.n_batches):
                next(loader)
            dt = time.perf_counter() - t0
        finally:
            loader.close()
        lines.append(emit(dict(
            metric="loader_imgs_per_sec", workers=w, pool="process" if w < 0 else "thread",
            imgs_per_sec=args.n_batches * args.batch_size / dt,
            sec_per_batch=dt / args.n_batches, batch_size=args.batch_size,
            n_batches=args.n_batches, host_cores=host_cores(), device="cpu")))
    return lines


if __name__ == "__main__":
    main()
