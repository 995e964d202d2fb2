"""Input pipeline: an iteration-based, thread-prefetched loader.

The reference feeds 2 GPUs from ONE DataLoader worker per rank
(dataloaders/__init__.py:99) — augmentation-bound input was part of its
0.92 s/iter. Here decode+augment runs in a thread pool (PIL releases the
GIL for decode/resize/filter), several batches are prefetched ahead, and
the device-side normalize runs inside the train step, so batches cross
host->device as uint8.

Epoch semantics mirror the reference (main.py:74-113): an infinite stream
of epochs, each a seeded shuffle of the split. Each data rank of a process
group reads its contiguous shard of every epoch's order
(``build_train_loader``'s ``process_index`` of ``process_count``); one
process is index 0 of 1.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from cosa_tpu_torch.data.datasets import (
    ClsTrainDataset,
    SegValDataset,
    build_base,
)

# ---------------------------------------------------------------------------
# process-pool decode workers (num_workers < 0): insurance against GIL
# contention on many-core hosts. PIL releases the GIL for decode/resize/
# filter, so threads scale on typical hosts (~6 img/s/core measured), but a
# Python-heavy augmentation mix can still serialize; -N forks N worker
# processes instead. The dataset is shipped ONCE per worker (pool
# initializer), only (epoch, idx) keys and sample dicts cross the pipe.
# ---------------------------------------------------------------------------
_WORKER_DS = None


def _pool_init(ds) -> None:
    global _WORKER_DS
    _WORKER_DS = ds


def _pool_get(key):
    return _WORKER_DS[key]


def _train_split(cfg) -> str:
    return {"VOC12": "train_aug", "COCO": "train", "synthetic": "train"}[cfg.dataset]


def _val_split(cfg) -> str:
    if cfg.dataset == "COCO":
        return "val" if cfg.valfull else "val_part"
    return "val"


def build_train_dataset(cfg, seed: Optional[int] = None) -> ClsTrainDataset:
    base = build_base(cfg, _train_split(cfg), "train")
    return ClsTrainDataset(
        base,
        crop_size=cfg.crop_size,
        rescale_range=cfg.scales,
        seed=cfg.seed if seed is None else seed,
    )


def build_val_dataset(cfg) -> SegValDataset:
    return SegValDataset(build_base(cfg, _val_split(cfg), "val"))


def build_test_dataset(cfg) -> SegValDataset:
    """Final-eval dataset. The reference's finaleval scores the val split
    (main.py:414); with ``eval_split="test"`` this returns the GT-less VOC
    test split (1456 imgs, dataloaders/voc.py test list) for eval-server
    submission dumps."""
    split = getattr(cfg, "eval_split", "val") or "val"
    if split == "test":
        return SegValDataset(build_base(cfg, "test", "test"))
    return SegValDataset(build_base(cfg, _val_split(cfg), "val"))


class TrainLoader:
    """Infinite loader yielding local-shard batches as stacked numpy dicts."""

    def __init__(
        self,
        dataset: ClsTrainDataset,
        batch_size: int,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 4,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        skip_batches: int = 0,
    ):
        """``skip_batches`` fast-forwards the deterministic index stream (no
        data is loaded for skipped batches) so a resumed run continues the
        exact data order of the original — impossible in the reference,
        whose sampler state lives in un-checkpointed worker processes."""
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.skip_batches = skip_batches
        self.pidx = 0 if process_index is None else process_index
        self.pcnt = 1 if process_count is None else process_count
        self._procs = None
        if num_workers < 0:  # process-pool decode (see _pool_init above)
            import multiprocessing as mp

            ctx = mp.get_context("fork" if hasattr(os, "fork") else "spawn")
            self._procs = ctx.Pool(
                -num_workers, initializer=_pool_init, initargs=(dataset,)
            )
        self.pool = ThreadPoolExecutor(max_workers=max(1, abs(num_workers)))
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._feeder, daemon=True)
        self._thread.start()

    def _index_stream(self) -> Iterator:
        n = len(self.ds)
        epoch = 0
        while True:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            order = rng.permutation(n)
            # per-process contiguous shard (drop remainder like the
            # reference's drop_last=True sampler)
            per = n // self.pcnt
            shard = order[self.pidx * per : (self.pidx + 1) * per]
            usable = (len(shard) // self.batch_size) * self.batch_size
            for i in range(0, usable, self.batch_size):
                yield epoch, shard[i : i + self.batch_size]
            epoch += 1

    def _feeder(self):
        try:
            stream = self._index_stream()
            for _ in range(self.skip_batches):
                next(stream)
            for epoch, idxs in stream:
                if self._stop.is_set():
                    return
                keys = [(epoch, int(i)) for i in idxs]
                if self._procs is not None:
                    samples = self._procs.map(_pool_get, keys)
                else:
                    futures = [
                        self.pool.submit(self.ds.__getitem__, k) for k in keys
                    ]
                    samples = [f.result() for f in futures]
                batch = dict(
                    wimg=np.stack([s["wimg"] for s in samples]),
                    simg=np.stack([s["simg"] for s in samples]),
                    cls_label=np.stack([s["cls_label"] for s in samples]),
                    img_box=np.stack([s["img_box"] for s in samples]),
                )
                while not self._stop.is_set():
                    try:
                        self.q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surface worker failures to the consumer
            # (a silently-dead feeder would block __next__ forever)
            while not self._stop.is_set():
                try:
                    self.q.put(e, timeout=0.5)
                    return
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self.q.get()
        if isinstance(item, BaseException):
            raise RuntimeError("TrainLoader worker failed") from item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.pool.shutdown(wait=False)
        if self._procs is not None:
            self._procs.terminate()


def build_train_loader(cfg, per_process_batch: int, num_workers: Optional[int] = None,
                       skip_batches: int = 0, process_index: int = 0,
                       process_count: int = 1):
    """The loader of data rank ``process_index`` of ``process_count``: its
    contiguous shard of each epoch's order, so global batch row
    ``r * per_process_batch + i`` is rank r's row i."""
    ds = build_train_dataset(cfg)
    return TrainLoader(
        ds,
        batch_size=per_process_batch,
        seed=cfg.seed,
        num_workers=cfg.num_workers if num_workers is None else num_workers,
        process_index=process_index,
        process_count=process_count,
        skip_batches=skip_batches,
    )
