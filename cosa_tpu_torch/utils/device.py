"""Device selection for the port's entry points.

Every entry point runs on the GPU unless its caller names another device.
Without a GPU, asking for it raises; nothing falls back to the CPU. Under a
process group the default is the card ``LOCAL_RANK`` (torchrun's one card
per rank); a caller may name one card for several ranks (gloo on one card).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        device = "cuda"
        if dist.is_available() and dist.is_initialized():
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on an NVIDIA GPU; pass "
                "device='cpu' to run its plain versions on the CPU"
            )
        # f32 parity with the reference: no TF32 in matmuls or (cuDNN)
        # convolutions, whose default would otherwise be TF32 on Hopper
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
