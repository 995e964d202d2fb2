"""The optimizer over the reference's four parameter groups (main.py:57-72
for the groups; utils/torch_helper.py:228-358 for the schedules), as the
JAX package's train/optimizer.py::build_optimizer selects it by
``cfg.optimizer``:

  backbone  encoder / Swin backbone, non-norm params   lr,           wd
  norm      their norms (+ Swin's rel_pos_bias)        lr,           wd * wt_dec_mult
  head      classifier + aux                           lr * lrscale, wd
  decoder   decoder                                    lr * lrscale, wd
  frozen    pos_embed                                  not in the optimizer

``freeze_norm`` takes the norm group out of the optimizer too.

  poly_adamw    the live PolyWarmupAdamW: AdamW, poly schedule with warmup
  cos_adamw     AdamW, CosWarmupAdamW's schedule (absolute warmup blend)
  poly_sgd      SGD, momentum 0.9, coupled weight decay; PolyWarmupSGD's
                schedule (its "warmup" decays from 10x)
  poly_cls_sgd  SGD with momentum = the group's wd and no decay (the
                reference passes weight_decay positionally into SGD's
                momentum slot, torch_helper.py:330); PolyOptimizer_cls's
                schedule, held constant for the lr-scaled groups

Each step sets every group's lr to its schedule(step) before ``step()``;
the schedules are evaluated in f32, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch

Schedule = Callable[[int], float]
_F = np.float32


def poly_warmup_schedule(base_lr: float, warmup_iter: int = 1500,
                         max_iter: int = 40000, warmup_ratio: float = 1e-6,
                         power: float = 0.9, min_mult: float = 0.0) -> Schedule:
    """lr(step) exactly as PolyWarmupAdamW.step computes it; past max_iter
    the last multiplier holds."""
    def sched(step: int) -> float:
        s = _F(min(step, max_iter - 1))
        if s < warmup_iter:
            # cancellation-free form of 1 - (1 - s/w)(1 - ratio)
            w = _F(warmup_iter)
            mult = s / w + (_F(1.0) - s / w) * _F(warmup_ratio)
        else:
            mult = max((_F(1.0) - s / _F(max_iter)) ** _F(power), _F(min_mult))
        return float(_F(base_lr) * mult)

    return sched


def cos_warmup_schedule(base_lr: float, warmup_iter: int = 1500,
                        max_iter: int = 40000, warmup_ratio: float = 1e-6) -> Schedule:
    """CosWarmupAdamW's lr(step): during warmup the reference's ABSOLUTE
    blend base*s/w + (1 - s/w)*ratio (the ratio term is not scaled by base),
    then a half cosine from base to 0 over the remaining iterations."""
    def sched(step: int) -> float:
        s = _F(min(step, max_iter - 1))
        if s < warmup_iter:
            w = _F(warmup_iter)
            return float(_F(base_lr) * (s / w) + (_F(1.0) - s / w) * _F(warmup_ratio))
        t = (s - _F(warmup_iter)) / _F(max_iter - warmup_iter)
        return float(_F(base_lr) * (np.cos(t * _F(math.pi)) * _F(0.5) + _F(0.5)))

    return sched


def poly_sgd_schedule(base_lr: float, warmup_iter: int = 1500,
                      max_iter: int = 40000, power: float = 0.9) -> Schedule:
    """PolyWarmupSGD's lr(step), quirk kept: during "warmup" the multiplier
    is (1 - s/w)^power * 10, a decay from 10x to 0, then the usual poly."""
    def sched(step: int) -> float:
        s = _F(min(step, max_iter - 1))
        if s < warmup_iter:
            mult = (_F(1.0) - s / _F(warmup_iter)) ** _F(power) * _F(10.0)
        else:
            mult = (_F(1.0) - (s - _F(warmup_iter)) / _F(max_iter - warmup_iter)) ** _F(power)
        return float(_F(base_lr) * mult)

    return sched


def poly_cls_schedule(base_lr: float, max_step: int, momentum: float = 0.9,
                      constant: bool = False) -> Schedule:
    """PolyOptimizer_cls's lr(step): (1 - s/max)^momentum (the exponent
    really is the ``momentum`` argument); ``constant`` holds the initial lr,
    the reference's special case for its last group."""
    def sched(step: int) -> float:
        if constant:
            return float(_F(base_lr))
        s = _F(min(step, max_step - 1))
        return float(_F(base_lr) * (_F(1.0) - s / _F(max_step)) ** _F(momentum))

    return sched


def lr_schedule(cfg, lr_mult: float) -> Schedule:
    """The schedule of a group whose lr is ``cfg.lr * lr_mult``."""
    lr = cfg.lr * lr_mult
    kind = cfg.optimizer
    if kind == "poly_adamw":
        return poly_warmup_schedule(lr, cfg.lr_warmup_iters, cfg.max_iters, 1e-6, 0.9,
                                    cfg.min_mult)
    if kind == "cos_adamw":
        return cos_warmup_schedule(lr, cfg.lr_warmup_iters, cfg.max_iters, 1e-6)
    if kind == "poly_sgd":
        return poly_sgd_schedule(lr, cfg.lr_warmup_iters, cfg.max_iters, 0.9)
    if kind == "poly_cls_sgd":
        # the reference's last group holds its initial lr; the lr-scaled
        # groups (head, decoder) play that role
        return poly_cls_schedule(lr, cfg.max_iters, 0.9, constant=lr_mult != 1.0)
    raise ValueError(f"unknown optimizer {kind!r}")


def param_label(name: str) -> str:
    if "pos_embed" in name:
        return "frozen"
    if name.startswith("encoder"):
        return "norm" if "norm" in name else "backbone"
    if name.startswith("backbone"):
        # SwinNetwork ('swinend2end'): the reference MMSWIN puts the norms
        # and the relative-position bias tables in the norm group
        # (mmsegmodel/__init__.py:88,131-148)
        return "norm" if ("norm" in name or "rel_pos_bias" in name) else "backbone"
    if "classifier" in name:  # classifier / aux_classifier
        return "head"
    if name.startswith("decoder"):
        return "decoder"
    return "backbone"


class GroupOptimizer:
    """``cfg.optimizer`` over the labelled groups, each group's lr set from
    its own schedule at every step."""

    def __init__(self, cfg, model: torch.nn.Module):
        kind = cfg.optimizer
        spec = {  # group: (lr multiplier, weight decay)
            "backbone": (1.0, cfg.wt_dec),
            "norm": (1.0, cfg.wt_dec * cfg.wt_dec_mult),
            "head": (cfg.lrscale, cfg.wt_dec),
            "decoder": (cfg.lrscale, cfg.wt_dec),
        }
        grouped: Dict[str, List[torch.nn.Parameter]] = {k: [] for k in spec}
        for name, p in model.named_parameters():
            label = param_label(name)
            if label == "frozen" or (label == "norm" and cfg.freeze_norm):
                p.requires_grad_(False)
                continue
            grouped[label].append(p)
        self.logged = lr_schedule(cfg, 1.0)
        self.scheds: List[Schedule] = []
        groups = []
        for k, (mult, wd) in spec.items():
            if not grouped[k]:
                continue
            sched = lr_schedule(cfg, mult)
            self.scheds.append(sched)
            if kind == "poly_cls_sgd":  # wd in SGD's momentum slot, no decay
                groups.append(dict(params=grouped[k], lr=sched(0), momentum=wd,
                                   weight_decay=0.0, name=k))
            else:
                groups.append(dict(params=grouped[k], lr=sched(0), weight_decay=wd, name=k))
        if kind.endswith("adamw"):
            fused = all(p.is_cuda for g in groups for p in g["params"])
            self.opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                         fused=fused or None)
        else:  # lr_schedule has refused any other kind
            self.opt = torch.optim.SGD(groups, lr=0.0, momentum=0.9)

    def lr_at(self, step: int) -> float:
        """The logged lr: the backbone group's schedule at ``step``."""
        return self.logged(step)

    def step(self, step: int) -> None:
        for g, sched in zip(self.opt.param_groups, self.scheds):
            g["lr"] = sched(step)
        self.opt.step()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)
