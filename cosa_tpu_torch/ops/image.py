"""Image normalization helpers (device-side), NHWC.

The reference normalizes with ImageNet mean/std at the 0-255 scale
(dataloaders/transforms.py:43-50, utils/torch_helper.py:354-367). Batches
cross to the device as uint8 and are normalized there.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def _stats(device):
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)
    return mean, std


def normalize(img_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (or float 0-255) NHWC -> normalized float.

    Arithmetic is always f32; ``dtype=torch.bfloat16`` only reduces the
    stored result (the quantization the model's patch-embed cast applies
    anyway)."""
    mean, std = _stats(img_u8.device)
    return ((img_u8.to(torch.float32) - mean) / std).to(dtype)


def denormalize_u8(img: torch.Tensor) -> torch.Tensor:
    """normalized f32 NHWC -> 0-255 f32 with uint8 truncation semantics
    (reference denormalize_img_ casts to uint8, torch_helper.py:354-361)."""
    mean, std = _stats(img.device)
    x = img * std + mean
    return torch.clamp(x, 0, 255).to(torch.uint8).to(torch.float32)


def denormalize01(img: torch.Tensor) -> torch.Tensor:
    """reference denormalize_img (torch_helper.py:363-367): uint8 / 255."""
    return denormalize_u8(img) / 255.0


def hflip(img: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of NHWC (W is dim -2)."""
    return torch.flip(img, dims=(-2,))
