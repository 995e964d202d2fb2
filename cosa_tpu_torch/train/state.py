"""Training state: student, EMA teacher, optimizer and step counter.

The student and the teacher are initialised from separate seeded
generators (the reference builds the two networks separately, so their
random heads start different). The GMM state of the JAX package exists
here only as the fixed thresholds; GMM thresholds are ROADMAP Queue 1
item 11.
"""

from __future__ import annotations

import dataclasses

import torch

from cosa_tpu_torch.models.network import CoSANetwork, build_model
from cosa_tpu_torch.train.optimizer import PolyWarmupAdamW


@dataclasses.dataclass
class TrainState:
    student: CoSANetwork
    teacher: CoSANetwork
    optimizer: PolyWarmupAdamW
    step: int = 0
    thre_low: float = 0.25
    thre_high: float = 0.7


def create_train_state(cfg, device=None) -> TrainState:
    """Student seeded with ``cfg.seed``, teacher with ``cfg.seed + 1``; the
    teacher never trains (eval mode, no gradients)."""
    student = build_model(cfg, device, seed=cfg.seed).train()
    teacher = build_model(cfg, device, seed=cfg.seed + 1).eval()
    teacher.requires_grad_(False)
    return TrainState(
        student=student,
        teacher=teacher,
        optimizer=PolyWarmupAdamW(cfg, student),
        thre_low=float(cfg.low_thre),
        thre_high=float(cfg.high_thre),
    )


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module, momentum: float) -> None:
    """teacher = m * teacher + (1 - m) * student over every parameter,
    pos_embed included, in f32 (in place)."""
    t = list(teacher.parameters())
    s = list(student.parameters())
    torch._foreach_mul_(t, momentum)
    torch._foreach_add_(t, s, alpha=1.0 - momentum)
