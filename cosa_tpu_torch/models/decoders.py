"""Segmentation decoder: DeepLab-LargeFOV (reference
models/decoder/conv_head.py:11-41): two 3x3 dilation-5 512-channel convs
and a 1x1, all bias-free, ReLU between. NHWC at the interface, NCHW only
inside the convolutions."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class LargeFOV(nn.Module):
    def __init__(self, in_planes: int, out_planes: int, embed_dim: int = 512,
                 dilation: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dilation = dilation
        self.dtype = dtype
        d = dilation
        self.conv6 = nn.Conv2d(in_planes, embed_dim, 3, padding=d, dilation=d, bias=False)
        self.conv7 = nn.Conv2d(embed_dim, embed_dim, 3, padding=d, dilation=d, bias=False)
        self.conv8 = nn.Conv2d(embed_dim, out_planes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, h, w, D) -> (B, h, w, out_planes) logits in ``dtype``."""
        d, dt = self.dilation, self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.relu(F.conv2d(x, self.conv6.weight.to(dt), padding=d, dilation=d))
        x = F.relu(F.conv2d(x, self.conv7.weight.to(dt), padding=d, dilation=d))
        x = F.conv2d(x, self.conv8.weight.to(dt))
        return x.permute(0, 2, 3, 1)
