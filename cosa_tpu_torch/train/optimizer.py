"""PolyWarmupAdamW with the reference's four parameter groups, on
``torch.optim.AdamW`` (reference utils/torch_helper.py:261-293 for the
schedule, main.py:57-72 for the groups):

  backbone  encoder, non-norm params   lr,           wd
  norm      encoder norm params        lr,           wd * wt_dec_mult
  head      classifier + aux           lr * lrscale, wd
  decoder   decoder                    lr * lrscale, wd
  frozen    pos_embed                  not in the optimizer

Each step sets every group's lr to schedule(step) before ``step()``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def poly_warmup_schedule(base_lr: float, warmup_iter: int = 1500,
                         max_iter: int = 40000, warmup_ratio: float = 1e-6,
                         power: float = 0.9, min_mult: float = 0.0):
    """lr(step) exactly as PolyWarmupAdamW.step computes it; past max_iter
    the last multiplier holds. Evaluated in f32, as the JAX package does."""
    f = np.float32

    def sched(step: int) -> float:
        s = f(min(step, max_iter - 1))
        if s < warmup_iter:
            # cancellation-free form of 1 - (1 - s/w)(1 - ratio)
            w = f(warmup_iter)
            mult = s / w + (f(1.0) - s / w) * f(warmup_ratio)
        else:
            mult = max((f(1.0) - s / f(max_iter)) ** f(power), f(min_mult))
        return float(f(base_lr) * mult)

    return sched


def param_label(name: str) -> str:
    if "pos_embed" in name:
        return "frozen"
    if name.startswith("encoder"):
        return "norm" if "norm" in name else "backbone"
    if "classifier" in name:  # classifier / aux_classifier
        return "head"
    if name.startswith("decoder"):
        return "decoder"
    return "backbone"


class PolyWarmupAdamW:
    """AdamW over the labelled groups, with the poly-warmup lr per step."""

    def __init__(self, cfg, model: torch.nn.Module):
        if cfg.optimizer != "poly_adamw":
            raise NotImplementedError(
                f"optimizer '{cfg.optimizer}': the port has poly_adamw only "
                "(the reference's unused constructors are not ported)"
            )
        self.sched = poly_warmup_schedule(
            1.0, cfg.lr_warmup_iters, cfg.max_iters, 1e-6, 0.9, cfg.min_mult
        )
        self.logged = poly_warmup_schedule(
            cfg.lr, cfg.lr_warmup_iters, cfg.max_iters, 1e-6, 0.9, cfg.min_mult
        )
        spec = {
            "backbone": (cfg.lr, cfg.wt_dec),
            "norm": (cfg.lr, cfg.wt_dec * cfg.wt_dec_mult),
            "head": (cfg.lr * cfg.lrscale, cfg.wt_dec),
            "decoder": (cfg.lr * cfg.lrscale, cfg.wt_dec),
        }
        grouped: Dict[str, List[torch.nn.Parameter]] = {k: [] for k in spec}
        for name, p in model.named_parameters():
            label = param_label(name)
            if label == "frozen" or (label == "norm" and cfg.freeze_norm):
                p.requires_grad_(False)
                continue
            grouped[label].append(p)
        groups = [
            dict(params=grouped[k], lr=lr, weight_decay=wd, base_lr=lr, name=k)
            for k, (lr, wd) in spec.items() if grouped[k]
        ]
        fused = all(p.is_cuda for g in groups for p in g["params"])
        self.opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                     fused=fused or None)

    def lr_at(self, step: int) -> float:
        """The logged lr: the backbone group's schedule at ``step``."""
        return self.logged(step)

    def step(self, step: int) -> None:
        mult = self.sched(step)
        for g in self.opt.param_groups:
            g["lr"] = g["base_lr"] * mult
        self.opt.step()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)
