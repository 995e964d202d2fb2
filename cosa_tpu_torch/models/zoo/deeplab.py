"""The DeepLab family (V1/V2/V3/V3+ on ResNet-101 and VGG16, the MSC
wrapper, BECO's DeepLabV3+), PyTorch, NHWC at every interface.

Port of the JAX package's models/zoo/deeplab.py (the reference's
vestigial zoo, models/deeplabs/*.py and models/res/deeplabv3plus.py):

  * ``DeepLabV1``          deeplabv1.py:17-33 (dilated ResNet + 1x1 conv)
  * ``DeepLabV1LargeFOV``  deeplab_resnet_v1.py:82-110 ('l2g_r101')
  * ``DeepLabV2``          deeplabv2.py:38-66, sum-fused ASPP ('l2g_r101_v2')
  * ``DeepLabV3``          deeplabv3.py:53-81 (multi-grid + improved ASPP)
  * ``DeepLabV3Plus``      deeplabv3plus.py:21-75
  * ``DeepLabV1VGG16`` / ``DeepLabV2VGG16``  deeplab_vgg_v{1,2}.py
  * ``MSC``                msc.py:14-47 (multi-scale max fusion)
  * ``BECODeepLabV3Plus``  res/deeplabv3plus.py:24-113 ('beco_r101')

Resizes are the port's ``ops/resize.py::resize_bilinear`` (torch's
bilinear, align_corners=False); global pools are means. Every module takes
its input channels, which flax infers.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cosa_tpu_torch.models.zoo.resnet import (
    ConvBN,
    Dropout,
    MSRAResLayer,
    MSRAStem,
    ResNetD,
    conv,
    max_pool_floor,
)
from cosa_tpu_torch.ops.resize import resize_bilinear

F32 = torch.float32


def _pooled(x: torch.Tensor, layer: ConvBN, train: bool) -> torch.Tensor:
    """The image-level branch: global mean -> ``layer`` -> broadcast over
    the map."""
    p = layer(x.mean(dim=(1, 2), keepdim=True), train)
    return p.expand(x.shape[0], x.shape[1], x.shape[2], p.shape[-1])


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------


class FOVHead(nn.Module):
    """LargeFOV head (deeplab_resnet_v1.py:27-57): 3x3 d12 -> 1024, 1x1 ->
    1024, 1x1 -> classes, dropout 0.5 between."""

    def __init__(self, cin: int, num_classes: int, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.conv6 = nn.Conv2d(cin, 1024, 3, padding=12, dilation=12)
        self.conv7 = nn.Conv2d(1024, 1024, 1)
        self.conv8 = nn.Conv2d(1024, num_classes, 1)
        self.drop = Dropout(0.5)

    def forward(self, x, train=False, generator=None):
        x = self.drop(F.relu(conv(x, self.conv6, self.dtype)), train, generator)
        x = self.drop(F.relu(conv(x, self.conv7, self.dtype)), train, generator)
        return conv(x, self.conv8, F32)


class ASPPv2(nn.Module):
    """Sum-fused ASPP (deeplabv2.py:17-35): one 3x3 dilated conv per rate,
    in f32, the outputs summed."""

    def __init__(self, cin: int, num_classes: int, rates: Tuple[int, ...] = (6, 12, 18, 24),
                 dtype: torch.dtype = F32):
        super().__init__()
        self.n = len(rates)
        for i, r in enumerate(rates):
            self.add_module(f"c{i}", nn.Conv2d(cin, num_classes, 3, padding=r, dilation=r))

    def forward(self, x, train=False, generator=None):
        out = conv(x, self.c0, F32)
        for i in range(1, self.n):
            out = out + conv(x, getattr(self, f"c{i}"), F32)
        return out


class ASPPv3(nn.Module):
    """Improved ASPP with image-level pooling (deeplabv3.py:19-50):
    concat[1x1, a 3x3 per rate, pooled] -> out_ch * (rates + 2) channels."""

    def __init__(self, cin: int, out_ch: int = 256, rates: Tuple[int, ...] = (6, 12, 18),
                 dtype: torch.dtype = F32):
        super().__init__()
        self.n = len(rates)
        self.c0 = ConvBN(cin, out_ch, 1, 1, 0, 1, True, dtype=dtype)
        for i, r in enumerate(rates):
            self.add_module(f"c{i + 1}", ConvBN(cin, out_ch, 3, 1, r, r, True, dtype=dtype))
        self.imagepool = ConvBN(cin, out_ch, 1, 1, 0, 1, True, dtype=dtype)

    def forward(self, x, train=False):
        outs = [getattr(self, f"c{i}")(x, train) for i in range(self.n + 1)]
        return torch.cat(outs + [_pooled(x, self.imagepool, train)], dim=-1)


class DepthwiseSeparableConv(nn.Module):
    """depthwise 3x3 + BN + ReLU, pointwise 1x1 + BN + ReLU
    (res/modules/convs/sep_conv.py)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, padding: int = 0,
                 dilation: int = 1, dtype: torch.dtype = F32):
        super().__init__()
        self.depthwise = ConvBN(cin, cin, kernel, 1, padding, dilation, True, groups=cin,
                                dtype=dtype)
        self.pointwise = ConvBN(cin, features, 1, 1, 0, 1, True, dtype=dtype)

    def forward(self, x, train=False):
        return self.pointwise(self.depthwise(x, train), train)


class SepASPP(nn.Module):
    """ASPP with depthwise-separable atrous branches, image pooling and a
    fused projector (res/modules/decoders/sep_aspp.py:18-63)."""

    def __init__(self, cin: int, channels: int = 256, rates: Tuple[int, ...] = (6, 12, 18),
                 dropout: float = 0.1, dtype: torch.dtype = F32):
        super().__init__()
        self.n = len(rates)
        self.conv1x1 = ConvBN(cin, channels, 1, 1, 0, 1, True, dtype=dtype)
        for i, r in enumerate(rates):
            self.add_module(f"sep{i}", DepthwiseSeparableConv(cin, channels, 3, r, r, dtype))
        self.pool_conv = ConvBN(cin, channels, 1, 1, 0, 1, True, dtype=dtype)
        self.projector = ConvBN(channels * (self.n + 2), channels, 1, 1, 0, 1, True,
                                dtype=dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, train=False, generator=None):
        outs = [self.conv1x1(x, train)]
        outs += [getattr(self, f"sep{i}")(x, train) for i in range(self.n)]
        outs.append(_pooled(x, self.pool_conv, train))
        x = self.projector(torch.cat(outs, dim=-1), train)
        return self.drop(x, train, generator)


# ---------------------------------------------------------------------------
# ResNet-101 DeepLabs (Kazuto flavour)
# ---------------------------------------------------------------------------

CH = [64 * 2 ** p for p in range(6)]  # 64 .. 2048


class _DilatedResNetBody(nn.Module):
    """The shared layer1..layer5 trunk; stride and dilation per variant."""

    def __init__(self, n_blocks: Tuple[int, ...], strides, dilations,
                 multi_grids: Optional[Tuple[int, ...]] = None, dtype: torch.dtype = F32):
        super().__init__()
        self.layer1 = MSRAStem(CH[0], dtype=dtype)
        cin = CH[0]
        for i, (n, out_ch) in enumerate(zip(n_blocks, CH[2:])):
            self.add_module(f"layer{i + 2}", MSRAResLayer(
                n, cin, out_ch, strides[i], dilations[i],
                multi_grids if i == 3 else None, dtype=dtype))
            cin = out_ch

    def forward(self, x, train=False):
        x = self.layer1(x, train)
        for i in range(2, 6):
            x = getattr(self, f"layer{i}")(x, train)
        return x


class DeepLabV1(nn.Module):
    """deeplabv1.py: dilated ResNet (os8, dilations 1/1/2/4) + a bare 1x1 conv."""

    def __init__(self, num_classes: int, n_blocks: Tuple[int, ...] = (3, 4, 23, 3),
                 dtype: torch.dtype = F32):
        super().__init__()
        self.body = _DilatedResNetBody(n_blocks, (1, 2, 1, 1), (1, 1, 2, 4), dtype=dtype)
        self.fc = nn.Conv2d(CH[5], num_classes, 1)

    def forward(self, x, train=False, generator=None):
        return conv(self.body(x, train), self.fc, F32)


class DeepLabV1LargeFOV(nn.Module):
    """deeplab_resnet_v1.py:82-110: the 'l2g_r101' branch."""

    def __init__(self, num_classes: int, n_blocks: Tuple[int, ...] = (3, 4, 23, 3),
                 dtype: torch.dtype = F32):
        super().__init__()
        self.body = _DilatedResNetBody(n_blocks, (1, 2, 1, 1), (1, 1, 2, 4), dtype=dtype)
        self.fov = FOVHead(CH[5], num_classes, dtype)

    def forward(self, x, train=False, generator=None):
        return self.fov(self.body(x, train), train, generator)


class DeepLabV2(nn.Module):
    """deeplabv2.py:38-66: 'l2g_r101_v2', the os8 trunk + sum-ASPP."""

    def __init__(self, num_classes: int, n_blocks: Tuple[int, ...] = (3, 4, 23, 3),
                 rates: Tuple[int, ...] = (6, 12, 18, 24), dtype: torch.dtype = F32):
        super().__init__()
        self.body = _DilatedResNetBody(n_blocks, (1, 2, 1, 1), (1, 1, 2, 4), dtype=dtype)
        self.aspp = ASPPv2(CH[5], num_classes, rates, dtype)

    def forward(self, x, train=False, generator=None):
        return self.aspp(self.body(x, train), train)


def _v3_strides_dils(output_stride: int):
    if output_stride == 8:
        return (1, 2, 1, 1), (1, 1, 2, 4), (12, 24, 36)
    assert output_stride == 16, output_stride
    return (1, 2, 2, 1), (1, 1, 1, 2), (6, 12, 18)


class DeepLabV3(nn.Module):
    """deeplabv3.py:53-81: multi-grid trunk + improved ASPP + fc1/fc2."""

    def __init__(self, num_classes: int, n_blocks: Tuple[int, ...] = (3, 4, 23, 3),
                 output_stride: int = 16, multi_grids: Tuple[int, ...] = (1, 2, 4),
                 dtype: torch.dtype = F32):
        super().__init__()
        strides, dils, rates = _v3_strides_dils(output_stride)
        self.body = _DilatedResNetBody(n_blocks, strides, dils, multi_grids, dtype)
        self.aspp = ASPPv3(CH[5], 256, rates, dtype)
        self.fc1 = ConvBN(256 * (len(rates) + 2), 256, 1, 1, 0, 1, True, dtype=dtype)
        self.fc2 = nn.Conv2d(256, num_classes, 1)

    def forward(self, x, train=False, generator=None):
        h = self.fc1(self.aspp(self.body(x, train), train), train)
        return conv(h, self.fc2, F32)


class DeepLabV3Plus(nn.Module):
    """deeplabv3plus.py:21-75: the V3 encoder + a low-level (layer2) skip
    decoder; logits upsampled to the input size, as the reference's
    forward does."""

    def __init__(self, num_classes: int, n_blocks: Tuple[int, ...] = (3, 4, 23, 3),
                 output_stride: int = 16, multi_grids: Tuple[int, ...] = (1, 2, 4),
                 dtype: torch.dtype = F32):
        super().__init__()
        strides, dils, rates = _v3_strides_dils(output_stride)
        self.layer1 = MSRAStem(CH[0], dtype=dtype)
        self.layer2 = MSRAResLayer(n_blocks[0], CH[0], CH[2], strides[0], dils[0], dtype=dtype)
        self.reduce = ConvBN(CH[2], 48, 1, 1, 0, 1, True, dtype=dtype)
        for i in (1, 2, 3):
            self.add_module(f"layer{i + 2}", MSRAResLayer(
                n_blocks[i], CH[1 + i], CH[2 + i], strides[i], dils[i],
                multi_grids if i == 3 else None, dtype=dtype))
        self.aspp = ASPPv3(CH[5], 256, rates, dtype)
        self.fc1 = ConvBN(256 * (len(rates) + 2), 256, 1, 1, 0, 1, True, dtype=dtype)
        self.fc2_conv1 = ConvBN(256 + 48, 256, 3, 1, 1, 1, True, dtype=dtype)
        self.fc2_conv2 = ConvBN(256, 256, 3, 1, 1, 1, True, dtype=dtype)
        self.fc2_conv3 = nn.Conv2d(256, num_classes, 1)

    def forward(self, x, train=False, generator=None):
        in_size = tuple(x.shape[1:3])
        h = self.layer2(self.layer1(x, train), train)
        low = self.reduce(h, train)
        for i in (3, 4, 5):
            h = getattr(self, f"layer{i}")(h, train)
        h = self.fc1(self.aspp(h, train), train)
        h = resize_bilinear(h.to(F32), tuple(low.shape[1:3])).to(h.dtype)
        h = self.fc2_conv2(self.fc2_conv1(torch.cat([h, low], dim=-1), train), train)
        h = conv(h, self.fc2_conv3, F32)
        return resize_bilinear(h, in_size)


# ---------------------------------------------------------------------------
# VGG16 DeepLabs
# ---------------------------------------------------------------------------


class _VGG16Trunk(nn.Module):
    """deeplab_vgg_v1.py:77-96: 13 convs, pool4/pool5 at stride 1, a
    dilation-2 block; the max pools are MaxPool2d(3, s, 1) in floor mode."""

    PLAN = [(64, 2), (128, 2), (256, 3)]

    def __init__(self, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        cin, i = 3, 0
        for feats, n in self.PLAN + [(512, 3), (512, 3)]:
            for _ in range(n):
                dil = 2 if i >= 10 else 1
                self.add_module(f"conv{i}", nn.Conv2d(cin, feats, 3, padding=dil, dilation=dil))
                cin, i = feats, i + 1

    def forward(self, x, train=False):
        i = 0
        for stage, (_, n) in enumerate(self.PLAN + [(512, 3), (512, 3)]):
            for _ in range(n):
                x = F.relu(conv(x, getattr(self, f"conv{i}"), self.dtype))
                i += 1
            x = max_pool_floor(x, 3, 2 if stage < 3 else 1, 1)
        return x


class DeepLabV1VGG16(nn.Module):
    """deeplab_vgg_v1.py:69-103: the VGG16 trunk + a FOV head."""

    def __init__(self, num_classes: int, dtype: torch.dtype = F32):
        super().__init__()
        self.trunk = _VGG16Trunk(dtype)
        self.aspp = FOVHead(512, num_classes, dtype)

    def forward(self, x, train=False, generator=None):
        return self.aspp(self.trunk(x, train), train, generator)


class DeepLabV2VGG16(nn.Module):
    """deeplab_vgg_v2.py:56-88: the VGG16 trunk + a 3-conv head per rate,
    summed."""

    def __init__(self, num_classes: int, rates: Tuple[int, ...] = (6, 12, 18, 24),
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.n = len(rates)
        self.trunk = _VGG16Trunk(dtype)
        for i, r in enumerate(rates):
            self.add_module(f"c{i}_conv1", nn.Conv2d(512, 1024, 3, padding=r, dilation=r))
            self.add_module(f"c{i}_conv2", nn.Conv2d(1024, 1024, 1))
            self.add_module(f"c{i}_conv3", nn.Conv2d(1024, num_classes, 1))
        self.drop = Dropout(0.5)

    def forward(self, x, train=False, generator=None):
        h = self.trunk(x, train)
        out = None
        for i in range(self.n):
            y = F.relu(conv(h, getattr(self, f"c{i}_conv1"), self.dtype))
            y = self.drop(y, train, generator)
            y = self.drop(F.relu(conv(y, getattr(self, f"c{i}_conv2"), self.dtype)),
                          train, generator)
            y = conv(y, getattr(self, f"c{i}_conv3"), F32)
            out = y if out is None else out + y
        return out


# ---------------------------------------------------------------------------
# MSC wrapper + BECO DeepLabV3+
# ---------------------------------------------------------------------------


class MSC(nn.Module):
    """Multi-scale max fusion (msc.py:14-47): ``base`` at 1.0 and at each
    extra scale, the logits upsampled to the 1.0-scale grid, pixel-wise
    max. ``train=True`` returns [logits@1, *logits@scales, max], as the
    reference's training mode does."""

    def __init__(self, base: nn.Module, scales: Sequence[float] = (0.5, 0.75)):
        super().__init__()
        self.base = base
        self.scales = tuple(scales)

    def forward(self, x, train=False, generator=None):
        logits = self.base(x, train, generator)
        hw = tuple(logits.shape[1:3])
        pyramid = [self.base(resize_bilinear(x, (int(x.shape[1] * s), int(x.shape[2] * s))),
                             train, generator) for s in self.scales]
        fused = torch.stack([logits] + [resize_bilinear(p.to(F32), hw) for p in pyramid]
                            ).amax(dim=0)
        if train:
            return [logits] + pyramid + [fused]
        return fused


class BECODeepLabV3Plus(nn.Module):
    """res/deeplabv3plus.py:24-113 ('beco_r101'): ResNet-D os16 trunk,
    SepASPP, a 48-channel low-level projector and a depthwise-separable
    pre-classifier. Logits at the low-level (1/4) grid, as the reference's
    forward gives them."""

    def __init__(self, num_classes: int, depth: int = 101, dtype: torch.dtype = F32):
        super().__init__()
        self.backbone = ResNetD(depth=depth, variety="resnet-D", output_stride=16,
                                out_indices=(1, 4), contract_dilation=False,
                                multi_grid=True, dtype=dtype)
        self.projector = ConvBN(256, 48, 1, 1, 0, 1, True, dtype=dtype)
        self.aspp = SepASPP(2048, 256, (6, 12, 18), dtype=dtype)
        self.pre_classifier = DepthwiseSeparableConv(48 + 256, 256, 3, 1, 1, dtype)
        self.classifier = nn.Conv2d(256, num_classes, 1)

    def forward(self, x, train=False, generator=None):
        out = self.backbone(x, train)
        low = self.projector(out[1], train)
        h = self.aspp(out[4], train, generator)
        h = resize_bilinear(h.to(F32), tuple(low.shape[1:3])).to(low.dtype)
        h = self.pre_classifier(torch.cat([low, h], dim=-1), train)
        return conv(h, self.classifier, F32)
