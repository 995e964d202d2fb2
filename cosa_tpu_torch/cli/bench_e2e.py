"""End-to-end input pipeline: on-disk JPEGs through the loader into the
full training step.

The port's counterpart of scripts/bench_e2e.py. It writes a miniature VOC-
or COCO-layout tree of JPEG photos (500 x 375, synthesized from a seed) to
a temporary directory, then runs data/loader.py::build_train_loader (8
decode workers) -> train/loop.py::to_device -> the co-training step, as
train/loop.py does, at the reference's global batch (VOC 4, COCO 8; COCO
takes its image-level labels from the masks). After the end-to-end steps
the same state and step run on the last batch, held on the device, for
the same number of steps: the compute-only sec/iter of the same run, so
the loader's cost reads from one line.

Warm-up 5 steps (the first builds the kernels), then
``n_iters`` steps on the host clock, each window ended by one
``torch.cuda.synchronize()``. It prints one JSON line: ``sec_per_iter``
and ``value`` (img/s) end to end, ``compute_sec_per_iter``,
``e2e_over_compute``, ``global_batch``, ``n_imgs``, ``num_workers``,
``backend``, ``device``, ``power_limit``.

    python -m cosa_tpu_torch.cli.bench_e2e [n_iters] [--dataset voc|coco]
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import tempfile
import time
from typing import Dict

import numpy as np

from cosa_tpu_torch.cli.bench import (
    add_model_args,
    device_info,
    emit,
    model_overrides,
    sync,
    time_calls,
)
from cosa_tpu_torch.config import coco_config, voc_config
from cosa_tpu_torch.data.loader import build_train_loader
from cosa_tpu_torch.train.loop import to_device
from cosa_tpu_torch.train.state import create_train_state
from cosa_tpu_torch.train.step import build_train_step
from cosa_tpu_torch.utils.device import resolve_device

NUM_WORKERS = 8
WARMUP = 5  # steps before the timed ones: the kernels' build, the loader's spin-up


def _photo(rng) -> np.ndarray:
    # a smooth random field: JPEG compresses it like a natural photo
    small = rng.random((12, 16, 3))
    img = np.kron(small, np.ones((32, 32, 1)))[:375, :500]
    return (img * 255 + rng.normal(0, 8, (375, 500, 3))).clip(0, 255)


def build_tree(root: str, dataset: str = "voc", n_imgs: int = 96) -> None:
    """``n_imgs`` JPEGs in the VOC12 layout (JPEGImages, splits/voc's
    train_aug list and class labels) or the COCO one (train2014, blocky
    instance masks under SegmentationClass/train2014, splits/coco/train.txt)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    names = []
    if dataset == "voc":
        jp = os.path.join(root, "JPEGImages")
        split_dir = os.path.join(root, "splits", "voc")
        os.makedirs(jp, exist_ok=True)
        os.makedirs(split_dir, exist_ok=True)
        for i in range(n_imgs):
            name = f"2007_{i:06d}"
            names.append(name)
            Image.fromarray(_photo(rng).astype(np.uint8)).save(
                os.path.join(jp, name + ".jpg"), quality=90)
        with open(os.path.join(split_dir, "train_aug.txt"), "w") as f:
            f.write("\n".join(names))
        labels = {n: (rng.random(20) > 0.7).astype(np.float32) for n in names}
        np.save(os.path.join(split_dir, "cls_labels_onehot.npy"), labels)  # type: ignore[arg-type]
    else:
        jp = os.path.join(root, "train2014")
        mp = os.path.join(root, "SegmentationClass", "train2014")
        split_dir = os.path.join(root, "splits", "coco")
        for d in (jp, mp, split_dir):
            os.makedirs(d, exist_ok=True)
        for i in range(n_imgs):
            name = f"COCO_train2014_{i:012d}"
            names.append(name)
            Image.fromarray(_photo(rng).astype(np.uint8)).save(
                os.path.join(jp, name + ".jpg"), quality=90)
            mask = np.zeros((375, 500), np.uint8)
            for cid in rng.integers(1, 81, size=3):
                y, x = rng.integers(0, 300), rng.integers(0, 400)
                mask[y:y + 75, x:x + 100] = cid
            Image.fromarray(mask).save(os.path.join(mp, name + ".png"))
        with open(os.path.join(split_dir, "train.txt"), "w") as f:
            f.write("\n".join(names))


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_iters", nargs="?", type=int, default=100)
    ap.add_argument("--dataset", choices=("voc", "coco"), default="voc")
    ap.add_argument("--n_imgs", type=int, default=96)
    add_model_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    info = device_info(dev)
    gbatch = 4 if args.dataset == "voc" else 8  # the reference's global batches
    make_cfg = voc_config if args.dataset == "voc" else coco_config
    root = tempfile.mkdtemp(prefix=f"cosa_e2e_{args.dataset}_")
    try:
        build_tree(root, args.dataset, args.n_imgs)
        cfg = make_cfg(batch_size=gbatch, data_root=root, split_dir=os.path.join(root, "splits"),
                       num_workers=NUM_WORKERS, energy_convention=1.0, **model_overrides(args))
        state = create_train_state(cfg, dev, gbatch)
        step = build_train_step(cfg)
        loader = build_train_loader(cfg, gbatch)
        try:
            for _ in range(WARMUP):
                batch = to_device(next(loader), dev)
                step(state, batch)
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(args.n_iters):
                batch = to_device(next(loader), dev)
                metrics = step(state, batch)
            sync(dev)
            dt = (time.perf_counter() - t0) / args.n_iters
        finally:
            loader.close()
        loss = float(metrics["overall_loss"])
        dt_c, metrics = time_calls(lambda: step(state, batch), args.n_iters, dev)
        if not (math.isfinite(loss) and math.isfinite(float(metrics["overall_loss"]))):
            raise FloatingPointError("non-finite loss in the timed steps")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return emit(dict(
        metric=f"{args.dataset}_e2e_train_imgs_per_sec", value=gbatch / dt, unit="img/s",
        sec_per_iter=dt, compute_sec_per_iter=dt_c, e2e_over_compute=dt / dt_c,
        global_batch=gbatch, n_iters=args.n_iters, n_imgs=args.n_imgs,
        num_workers=NUM_WORKERS, backend=dev.type, **info))


if __name__ == "__main__":
    main()
