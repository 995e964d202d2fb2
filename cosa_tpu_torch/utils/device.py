"""Device selection for the port's entry points.

Every entry point runs on the GPU unless its caller names another device.
Without a GPU, asking for it raises; nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
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
