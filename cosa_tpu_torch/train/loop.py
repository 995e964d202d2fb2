"""Training loop: the step loop of the JAX package's train/loop.py
(``train`` and ``_train_body``) with its windowed ``metrics.jsonl`` /
``print.out`` logging.

Metrics stay on the device between log points and cross to the host in
one transfer per window. Validation, checkpoints and the final evaluation
are ROADMAP Queue 1 items 7 and 8: a run that would reach one raises
before it starts.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from cosa_tpu_torch.config import Config, diff_from_preset
from cosa_tpu_torch.data.loader import build_train_dataset, build_train_loader
from cosa_tpu_torch.models.network import require_cosa_interface
from cosa_tpu_torch.train.state import create_train_state
from cosa_tpu_torch.train.step import build_train_step
from cosa_tpu_torch.utils.device import resolve_device
from cosa_tpu_torch.utils.logging import AverageMeter, MetricWriter, eta_string
from cosa_tpu_torch.utils.metrics import compute_mAP

LOSS_KEYS = ("overall_loss", "cls_loss", "cls_aux_loss",
             "seg_loss", "cam_loss", "reg_loss")


def output_dir(cfg: Config) -> str:
    return cfg.output_dir or os.path.join(cfg.work_dir, cfg.name)


def train(cfg: Config, max_steps: Optional[int] = None, device=None) -> Dict:
    """Co-train ``cfg`` for min(max_iters, max_steps) steps on ``device``
    (default: the GPU; it raises when there is none)."""
    require_cosa_interface(cfg)
    total = min(cfg.max_iters, max_steps or cfg.max_iters)
    if cfg.eval_iters <= total:
        raise NotImplementedError(
            f"eval_iters={cfg.eval_iters} <= {total} steps: validation and "
            "checkpoints are ROADMAP Queue 1 items 7-8; set eval_iters above "
            "the run length"
        )
    if cfg.random_seed:
        import random as _random

        cfg = cfg.replace(seed=_random.randint(1, 10000), random_seed=False)
    dev = resolve_device(device)
    out_dir = output_dir(cfg)
    writer = MetricWriter(out_dir)
    writer.print(f"config diff vs {cfg.dataset} preset:", diff_from_preset(cfg))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    writer.print(f"device: {dev} ({name})")

    state = create_train_state(cfg, dev)
    writer.print("weights: random init (seeded); pretrained loading is not ported yet")

    cfg = resolve_convention(cfg, dev, writer)
    step_fn = build_train_step(cfg)
    loader = build_train_loader(cfg, cfg.batch_size)
    n_params = sum(p.numel() for p in state.student.parameters())
    writer.print(f"Number of trainable params for Network: {n_params // 1_000_000}M")
    t0 = time.time()
    try:
        records = _train_body(cfg, state, step_fn, loader, writer, dev, total, t0)
    finally:
        loader.close()
    writer.print(f"Training done in {time.time() - t0:.0f}s.")
    writer.close()
    return dict(state=state, records=records, energy_convention=cfg.energy_convention)


def resolve_convention(cfg: Config, dev, writer: Optional[MetricWriter] = None) -> Config:
    """``cfg`` with its rff->lattice energy convention calibrated on the
    first training crops, when it is 0 (auto) and the filter is RFF."""
    if cfg.energy_filter != "rff" or cfg.energy_convention > 0:
        return cfg
    from cosa_tpu_torch.objectives.energy import resolve_energy_convention

    cal_ds = build_train_dataset(cfg)
    imgs = np.stack([cal_ds[(0, i)]["wimg"] for i in range(min(4, len(cal_ds)))])
    conv, info = resolve_energy_convention(cfg, imgs, device=dev)
    if writer is not None:
        writer.print(f"energy convention auto-calibrated: {conv:.4f} {info}")
    return cfg.replace(energy_convention=conv)


def to_device(batch: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev, non_blocking=True)
            for k, v in batch.items()}


def _train_body(cfg, state, step_fn, loader, writer, dev, total, t0):
    meter = AverageMeter()
    pending = []
    records = []
    t_log = time.time()
    for n_iter in range(total):
        local_batch = next(loader)
        metrics = step_fn(state, to_device(local_batch, dev))
        pending.append(metrics)
        if (n_iter + 1) % cfg.log_iters != 0:
            continue
        # ONE device->host transfer for the whole window
        last = pending[-1]
        stacked = torch.stack([torch.stack([m[k] for k in LOSS_KEYS]) for m in pending])
        probs = torch.sigmoid(torch.stack([last["cls_logits"], last["cls_aux_logits"]]))
        host = torch.cat([stacked.reshape(-1), probs.reshape(-1)]).cpu().numpy()
        nwin = len(pending)
        for row in host[: nwin * 6].reshape(nwin, 6):
            meter.add(dict(zip(LOSS_KEYS, row)))
        ncls = cfg.num_classes - 1
        probs = host[nwin * 6:].reshape(2, -1, ncls)
        labels = np.asarray(local_batch["cls_label"])
        cls_acc = float(np.mean(compute_mAP(labels, probs[0]) or [0.0]))
        cls_aux_acc = float(np.mean(compute_mAP(labels, probs[1]) or [0.0]))
        pending = []
        itertime = (time.time() - t_log) / nwin
        t_log = time.time()
        elapsed, eta = eta_string(t0, n_iter + 1, total)
        rec = dict(
            iter=n_iter + 1,
            itertime=itertime,
            imgs_per_sec=cfg.batch_size / itertime,
            lr=last["lr"],
            thre_low=round(last["thre_low"], 4),
            thre_high=round(last["thre_high"], 4),
            cls_acc=round(cls_acc, 3),
            cls_aux_acc=round(cls_aux_acc, 3),
            **{k: float(meter.pop(k)) for k in LOSS_KEYS},
        )
        records.append(rec)
        writer.log({"kind": "train", **rec})
        writer.print(
            f"Iter: {rec['iter']}; Elapsed: {elapsed}; ETA: {eta}; "
            f"Itertime: {rec['itertime']:.3f}s ({rec['imgs_per_sec']:.2f} img/s); "
            f"LR: {rec['lr']:.3e};\n overall_loss: {rec['overall_loss']:.4f}, "
            f"cls_loss: {rec['cls_loss']:.4f}, cls_acc: {rec['cls_acc']:.3f}, "
            f"cls_aux_loss: {rec['cls_aux_loss']:.4f}, "
            f"cls_aux_acc: {rec['cls_aux_acc']:.3f}, "
            f"seg_loss: {rec['seg_loss']:.4f}, cam_loss: {rec['cam_loss']:.4f}, "
            f"reg_loss: {rec['reg_loss']:.4f}"
        )
    return records
