"""WideResNet-38 (ResNet38d) classifier trunk + its seg variant, PyTorch,
NHWC at every interface.

Port of the JAX package's models/zoo/resnet38.py (the reference's
vestigial 'res38' branch, models/res/resnet38d.py:6-227 and
resnet38_seg.py:8-42): pre-activation residual blocks (BN + ReLU before
every conv, BN decay 0.9) with dilated stages 5-7 at output stride 8;
dropout inside the bottleneck blocks is live only with ``train``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from cosa_tpu_torch.models.zoo.resnet import BatchNorm, Dropout, conv

F32 = torch.float32


class _Conv(nn.Module):
    """A bias-free conv, padded by its dilation when 3x3."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        pad = dilation if kernel == 3 else 0
        self.conv = nn.Conv2d(cin, features, kernel, stride, pad, dilation, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv(x, self.conv, self.dtype)


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, momentum=0.9)


class ResBlock(nn.Module):
    """Pre-activation 2-conv residual block (resnet38d.py:7-56)."""

    def __init__(self, cin: int, mid: int, out: int, stride: int = 1, dilation: int = 1,
                 first_dilation: int = 0, dtype: torch.dtype = F32):
        super().__init__()
        fd = first_dilation or dilation
        self.same = cin == out and stride == 1
        self.bn_branch2a = _bn(cin)
        if not self.same:
            self.conv_branch1 = _Conv(cin, out, 1, stride, dtype=dtype)
        self.conv_branch2a = _Conv(cin, mid, 3, stride, fd, dtype=dtype)
        self.bn_branch2b1 = _bn(mid)
        self.conv_branch2b1 = _Conv(mid, out, 3, 1, dilation, dtype=dtype)

    def forward(self, x, train=False):
        act = F.relu(self.bn_branch2a(x, train))
        branch1 = x if self.same else self.conv_branch1(act)
        b2 = self.bn_branch2b1(self.conv_branch2a(act), train)
        return branch1 + self.conv_branch2b1(F.relu(b2))


class ResBlockBot(nn.Module):
    """Pre-activation bottleneck with dropout (resnet38d.py:58-107)."""

    def __init__(self, cin: int, out: int, stride: int = 1, dilation: int = 1,
                 dropout: float = 0.0, dtype: torch.dtype = F32):
        super().__init__()
        self.drop = Dropout(dropout)
        self.bn_branch2a = _bn(cin)
        self.conv_branch1 = _Conv(cin, out, 1, stride, dtype=dtype)
        self.conv_branch2a = _Conv(cin, out // 4, 1, stride, dtype=dtype)
        self.bn_branch2b1 = _bn(out // 4)
        self.conv_branch2b1 = _Conv(out // 4, out // 2, 3, 1, dilation, dtype=dtype)
        self.bn_branch2b2 = _bn(out // 2)
        self.conv_branch2b2 = _Conv(out // 2, out, 1, 1, dtype=dtype)

    def forward(self, x, train=False, generator=None):
        act = F.relu(self.bn_branch2a(x, train))
        branch1 = self.conv_branch1(act)
        b2 = F.relu(self.bn_branch2b1(self.conv_branch2a(act), train))
        b2 = self.conv_branch2b1(self.drop(b2, train, generator))
        b2 = F.relu(self.bn_branch2b2(b2, train))
        b2 = self.conv_branch2b2(self.drop(b2, train, generator))
        return branch1 + b2


def _plan(w: int = 1):
    """(name, mid, out, stride, dilation, first_dilation) per block,
    reference resnet38d.py:131-157; ``w`` divides the widths (tests)."""
    def d(c):
        return max(c // w, 4)

    return [
        ("b2", d(128), d(128), 2, 1, 0), ("b2_1", d(128), d(128), 1, 1, 0),
        ("b2_2", d(128), d(128), 1, 1, 0),
        ("b3", d(256), d(256), 2, 1, 0), ("b3_1", d(256), d(256), 1, 1, 0),
        ("b3_2", d(256), d(256), 1, 1, 0),
        ("b4", d(512), d(512), 2, 1, 0), ("b4_1", d(512), d(512), 1, 1, 0),
        ("b4_2", d(512), d(512), 1, 1, 0), ("b4_3", d(512), d(512), 1, 1, 0),
        ("b4_4", d(512), d(512), 1, 1, 0), ("b4_5", d(512), d(512), 1, 1, 0),
        ("b5", d(512), d(1024), 1, 2, 1), ("b5_1", d(512), d(1024), 1, 2, 0),
        ("b5_2", d(512), d(1024), 1, 2, 0),
    ]


class WRN38Cls(nn.Module):
    """resnet38d.Net (the WRN38_cls export, res/__init__.py:2): returns
    {'conv7': the post-bn7 ReLU features (4096 channels, os8), 'xb7': pre-bn7}."""

    def __init__(self, width_div: int = 1, depth_div: int = 1, dtype: torch.dtype = F32):
        super().__init__()

        def d(c):
            return max(c // width_div, 4)

        self.conv1a = _Conv(3, d(64), 3, 1, dtype=dtype)
        plan = _plan(width_div)
        if depth_div > 1:  # keep only each stage's first block
            plan = [p for p in plan if "_" not in p[0][2:]]
        self.names = [p[0] for p in plan]
        cin = d(64)
        for name, mid, out, stride, dil, fd in plan:
            self.add_module(name, ResBlock(cin, mid, out, stride, dil, fd, dtype=dtype))
            cin = out
        self.b6 = ResBlockBot(cin, d(2048), 1, 4, 0.3, dtype=dtype)
        self.b7 = ResBlockBot(d(2048), d(4096), 1, 4, 0.5, dtype=dtype)
        self.bn7 = _bn(d(4096))

    def forward(self, x, train=False, generator=None) -> Dict[str, torch.Tensor]:
        x = self.conv1a(x)
        for name in self.names:
            x = getattr(self, name)(x, train)
        x = self.b6(x, train, generator)
        xb7 = self.b7(x, train, generator)
        return {"conv7": F.relu(self.bn7(xb7, train)), "xb7": xb7}


class WRN38Seg(nn.Module):
    """resnet38_seg.Net (the WRN38 export): the WRN38Cls trunk + two 3x3
    dilation-12 seg convs (fc8_seg_conv1/2, resnet38_seg.py:13-18).
    Logits at os8."""

    def __init__(self, num_classes: int, width_div: int = 1, depth_div: int = 1,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.trunk = WRN38Cls(width_div, depth_div, dtype)
        mid = max(512 // width_div, 4)
        self.fc8_seg_conv1 = nn.Conv2d(max(4096 // width_div, 4), mid, 3, padding=12,
                                       dilation=12)
        self.fc8_seg_conv2 = nn.Conv2d(mid, num_classes, 3, padding=12, dilation=12)

    def forward(self, x, train=False, generator=None):
        feats = self.trunk(x, train, generator)["conv7"]
        h = conv(feats, self.fc8_seg_conv1, self.dtype)
        return conv(F.relu(h), self.fc8_seg_conv2, F32)
