"""The mmseg-config family (UPerNet-Swin, DeepLabV3/V3+ on ResNetV1c),
PyTorch, NHWC at every interface, mmcv/mmseg-free.

Port of the JAX package's models/zoo/mmseg.py (the reference's 'mmseg'
factory branch, models/__init__.py:71-72, mmsegmodel/__init__.py:29-75):

  * ``uper-swin-{t,s,b}``  (cfg_swin_{t,s,b}.py): Swin (out_indices 0-3) +
    UPerHead (PPM pool scales 1/2/3/6, 512 channels) + an FCNHead aux on
    stage 2;
  * ``deeplab3``   (deeplab3.py): ResNetV1c-101 os8 with contract_dilation +
    ASPPHead (512 channels, dilations 1/12/24/36) + an FCNHead aux;
  * ``deeplab3p``  (deeplab3p.py): the same trunk + the depthwise-separable
    ASPP head with its 48-channel c1 skip + an FCNHead aux.

Heads emit logits at their own grid; ``aux=True`` also returns the FCN
auxiliary logits. The auxiliary head's parameters always exist here (the
JAX package creates them only when a call asks for ``aux``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cosa_tpu_torch.models.zoo.deeplab import DepthwiseSeparableConv, _pooled
from cosa_tpu_torch.models.zoo.resnet import ConvBN, Dropout, ResNetD, conv
from cosa_tpu_torch.models.zoo.swin import SWIN_CONFIGS, SwinBackbone
from cosa_tpu_torch.ops.resize import resize_bilinear

F32 = torch.float32


def _up(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return resize_bilinear(x.to(F32), hw).to(x.dtype)


def adaptive_avg_pool(x: torch.Tensor, s: int) -> torch.Tensor:
    """NHWC adaptive average pool to (s, s) (torch AdaptiveAvgPool2d: bin i
    averages rows floor(i*n/s) .. ceil((i+1)*n/s)-1, also for s > n)."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), s).permute(0, 2, 3, 1)


class PPM(nn.Module):
    """Pyramid pooling over the last stage (mmseg UPerHead.psp_modules)."""

    def __init__(self, cin: int, channels: int, scales: Tuple[int, ...] = (1, 2, 3, 6),
                 dtype: torch.dtype = F32):
        super().__init__()
        self.scales = scales
        for i in range(len(scales)):
            self.add_module(f"pool{i}", ConvBN(cin, channels, 1, 1, 0, 1, True, dtype=dtype))
        self.bottleneck = ConvBN(cin + len(scales) * channels, channels, 3, 1, 1, 1, True,
                                 dtype=dtype)

    def forward(self, x, train=False):
        hw = tuple(x.shape[1:3])
        outs = [x]
        for i, s in enumerate(self.scales):
            p = getattr(self, f"pool{i}")(adaptive_avg_pool(x, s), train)
            outs.append(_up(p, hw))
        return self.bottleneck(torch.cat(outs, dim=-1), train)


class UPerHead(nn.Module):
    """The UPerNet decode head (mmseg UPerHead): PPM on top + an FPN fuse
    at the 1/4 grid."""

    def __init__(self, in_channels: Sequence[int], num_classes: int, channels: int = 512,
                 dropout: float = 0.1, dtype: torch.dtype = F32):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels[:-1]):
            self.add_module(f"lateral{i}", ConvBN(c, channels, 1, 1, 0, 1, True, dtype=dtype))
        self.ppm = PPM(in_channels[-1], channels, dtype=dtype)
        for i in range(self.n - 1):
            self.add_module(f"fpn{i}", ConvBN(channels, channels, 3, 1, 1, 1, True,
                                              dtype=dtype))
        self.fpn_bottleneck = ConvBN(self.n * channels, channels, 3, 1, 1, 1, True,
                                     dtype=dtype)
        self.drop = Dropout(dropout)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats, train=False, generator=None):
        laterals = [getattr(self, f"lateral{i}")(f, train) for i, f in enumerate(feats[:-1])]
        laterals.append(self.ppm(feats[-1], train))
        for i in range(len(laterals) - 1, 0, -1):  # the top-down pathway
            laterals[i - 1] = laterals[i - 1] + _up(laterals[i], laterals[i - 1].shape[1:3])
        outs = [getattr(self, f"fpn{i}")(laterals[i], train) for i in range(self.n - 1)]
        outs.append(laterals[-1])
        hw = tuple(outs[0].shape[1:3])
        x = self.fpn_bottleneck(torch.cat([_up(o, hw) for o in outs], dim=-1), train)
        return conv(self.drop(x, train, generator), self.conv_seg, F32)


class FCNHead(nn.Module):
    """mmseg FCNHead (num_convs=1, concat_input=False)."""

    def __init__(self, cin: int, num_classes: int, channels: int = 256, dropout: float = 0.1,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.conv0 = ConvBN(cin, channels, 3, 1, 1, 1, True, dtype=dtype)
        self.drop = Dropout(dropout)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, x, train=False, generator=None):
        x = self.drop(self.conv0(x, train), train, generator)
        return conv(x, self.conv_seg, F32)


class ASPPHead(nn.Module):
    """mmseg ASPPHead: dilations (1, r1, r2, r3) + an image pool, a 3x3
    bottleneck."""

    def __init__(self, cin: int, num_classes: int, channels: int = 512,
                 rates: Tuple[int, ...] = (12, 24, 36), dropout: float = 0.1,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.n = len(rates)
        self.aspp0 = ConvBN(cin, channels, 1, 1, 0, 1, True, dtype=dtype)
        for i, r in enumerate(rates):
            self.add_module(f"aspp{i + 1}", ConvBN(cin, channels, 3, 1, r, r, True,
                                                   dtype=dtype))
        self.image_pool = ConvBN(cin, channels, 1, 1, 0, 1, True, dtype=dtype)
        self.bottleneck = ConvBN(channels * (self.n + 2), channels, 3, 1, 1, 1, True,
                                 dtype=dtype)
        self.drop = Dropout(dropout)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, x, train=False, generator=None):
        outs = [getattr(self, f"aspp{i}")(x, train) for i in range(self.n + 1)]
        outs.append(_pooled(x, self.image_pool, train))
        x = self.bottleneck(torch.cat(outs, dim=-1), train)
        return conv(self.drop(x, train, generator), self.conv_seg, F32)


class SepASPPHead(nn.Module):
    """mmseg DepthwiseSeparableASPPHead: ASPP with separable atrous branches
    + a 48-channel c1 skip + two separable fuse convs; logits at the c1
    (1/4) grid. Takes (c1, x)."""

    def __init__(self, c1_in: int, cin: int, num_classes: int, channels: int = 512,
                 rates: Tuple[int, ...] = (12, 24, 36), dropout: float = 0.1,
                 c1_channels: int = 48, dtype: torch.dtype = F32):
        super().__init__()
        self.n = len(rates)
        self.aspp0 = ConvBN(cin, channels, 1, 1, 0, 1, True, dtype=dtype)
        for i, r in enumerate(rates):
            self.add_module(f"sep_aspp{i + 1}",
                            DepthwiseSeparableConv(cin, channels, 3, r, r, dtype))
        self.image_pool = ConvBN(cin, channels, 1, 1, 0, 1, True, dtype=dtype)
        self.bottleneck = ConvBN(channels * (self.n + 2), channels, 3, 1, 1, 1, True,
                                 dtype=dtype)
        self.c1_bottleneck = ConvBN(c1_in, c1_channels, 1, 1, 0, 1, True, dtype=dtype)
        self.sep_fuse1 = DepthwiseSeparableConv(channels + c1_channels, channels, 3, 1, 1,
                                                dtype)
        self.sep_fuse2 = DepthwiseSeparableConv(channels, channels, 3, 1, 1, dtype)
        self.drop = Dropout(dropout)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats, train=False, generator=None):
        c1, x = feats
        outs = [self.aspp0(x, train)]
        outs += [getattr(self, f"sep_aspp{i + 1}")(x, train) for i in range(self.n)]
        outs.append(_pooled(x, self.image_pool, train))
        x = self.bottleneck(torch.cat(outs, dim=-1), train)
        c1 = self.c1_bottleneck(c1, train)
        x = torch.cat([_up(x, c1.shape[1:3]), c1], dim=-1)
        x = self.sep_fuse2(self.sep_fuse1(x, train), train)
        return conv(self.drop(x, train, generator), self.conv_seg, F32)


class UPerSwin(nn.Module):
    """'uper-swin-{t,s,b}' (cfg_swin_*.py): Swin + UPerHead (+ the FCN aux)."""

    def __init__(self, num_classes: int, backbone: str = "swin-t",
                 dtype: torch.dtype = F32):
        super().__init__()
        cfg = SWIN_CONFIGS[backbone]
        widths = [cfg.embed_dim * 2 ** i for i in range(4)]
        self.backbone = SwinBackbone(cfg, (0, 1, 2, 3), dtype)
        self.decode_head = UPerHead(widths, num_classes, 512, dtype=dtype)
        self.auxiliary_head = FCNHead(widths[2], num_classes, 256, dtype=dtype)

    def forward(self, x, train=False, aux=False, generator=None):
        outs, _ = self.backbone(x, train, generator)
        main = self.decode_head(outs, train, generator)
        if not aux:
            return main
        return main, self.auxiliary_head(outs[2], train, generator)


class MMSegDeepLab3(nn.Module):
    """'deeplab3' (deeplab3.py): ResNetV1c-101 os8 + ASPPHead (+ the FCN
    aux); ``separable=True`` is 'deeplab3p'."""

    def __init__(self, num_classes: int, depth: int = 101, separable: bool = False,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.separable = separable
        self.backbone = ResNetD(depth=depth, variety="resnet-C", output_stride=8,
                                out_indices=(1, 2, 3, 4), contract_dilation=True,
                                multi_grid=False, dtype=dtype)
        if separable:
            self.decode_head = SepASPPHead(256, 2048, num_classes, 512, (12, 24, 36),
                                           dtype=dtype)
        else:
            self.decode_head = ASPPHead(2048, num_classes, 512, (12, 24, 36), dtype=dtype)
        self.auxiliary_head = FCNHead(1024, num_classes, 256, dtype=dtype)

    def forward(self, x, train=False, aux=False, generator=None):
        out = self.backbone(x, train)
        head_in = (out[1], out[4]) if self.separable else out[4]
        main = self.decode_head(head_in, train, generator)
        if not aux:
            return main
        return main, self.auxiliary_head(out[3], train, generator)
