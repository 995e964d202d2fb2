"""Seeded weights and derived seeds.

The benchmark draws the network's weights itself, on the card, from the
run's seed, in one normal draw per network, and hands the same tensors to
the program and to the plain reference. Scheme: dense and convolution
weights N(0, 1/fan_in), position embedding, class token and biases
N(0, 0.02), LayerNorm scales 1 and shifts 0; every normal draw is clamped
at two standard deviations. The student and the teacher share the
encoder's draw (the pretrained backbone both load in a CoSA run) and draw
their decoder and CAM heads apart.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def subseed(seed: int, *path: int) -> int:
    """A 63-bit seed for a purpose ``path`` of the run's ``seed`` (any
    non-negative integer, however large)."""
    return int(np.random.SeedSequence([int(seed), *path]).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _std(name: str, shape: Tuple[int, ...]) -> float:
    if name.endswith(("pos_embed", "cls_token", "bias")):
        return 0.02
    return 1.0 / math.sqrt(math.prod(shape[1:]))


def draw(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """One f32 tensor per name, from one normal draw on ``device``."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, device), device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        k = math.prod(shape)
        t = flat[at:at + k].view(shape)
        at += k
        if ".norm" in name or name.startswith("encoder.norm"):
            t = torch.ones(shape, device=device) if name.endswith("weight") \
                else torch.zeros(shape, device=device)
        else:
            t = t * _std(name, shape)
        out[name] = t
    return out


def network_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(student, teacher) weights of one run."""
    student = draw(shapes, subseed(seed, 1), device)
    heads = {k: v for k, v in shapes.items() if not k.startswith("encoder.")}
    teacher = {**student, **draw(heads, subseed(seed, 2), device)}
    return student, teacher
