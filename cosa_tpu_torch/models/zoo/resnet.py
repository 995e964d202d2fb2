"""ResNet backbones for the DeepLab zoo, PyTorch (NHWC at every interface).

Port of the JAX package's models/zoo/resnet.py. Two ResNet flavours, kept
apart because their pretrained layouts differ:

  * the MSRA / Kazuto DeepLab backbone (reference deeplabs/resnet.py:26-122):
    stride on the first 1x1 of each bottleneck, 7x7 stem + ceil-mode max
    pool, BN decay 0.999 (``MSRABottleneck``, ``MSRAResLayer``, ``MSRAStem``);
  * the BECO ResNet-B/C/D (res/modules/backbones/resnet.py:182-384):
    stride on the 3x3, deep 3-conv stem, avg-pool shortcut
    (``DBottleneck``, ``ResNetD``).

The zoo's shared layers live here too: :class:`BatchNorm` (flax's
semantics), :class:`Dropout` and :func:`conv`. Maps stay NHWC, as in the
JAX package; each convolution views them as NCHW, which is the
channels-last layout cuDNN takes natively. Module names are the JAX
tree's, so ``state_dict_from_jax`` carries params and ``batch_stats`` over.
Every forward takes ``train`` (batch statistics and live dropout) and the
``generator`` its dropout draws from, as the JAX modules take ``train``
and a dropout rng.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` on an NHWC map, its input, weight and bias cast to
    ``dtype`` (a flax ``nn.Conv(dtype=...)``); NHWC out."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), layer.weight.to(dtype), bias,
                 layer.stride, layer.padding, layer.dilation, layer.groups)
    return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last (channel) axis, in f32 with an
    f32 output. In train mode it normalizes by the batch statistics,
    E[x] and the BIASED variance E[x^2] - E[x]^2 (clipped at 0), and moves
    the running statistics by ``r = momentum * r + (1 - momentum) * stat``
    (``momentum`` is flax's decay; torch's BatchNorm would take the unbiased
    variance and 1 - decay). ``running_mean``/``running_var`` are the JAX
    tree's ``batch_stats`` ``mean``/``var``."""

    def __init__(self, features: int, momentum: float, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.to(torch.float32)
        if train:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class Dropout(nn.Module):
    """Elementwise dropout, live only with ``train`` (flax ``nn.Dropout``:
    kept values scaled by 1/(1 - p)); the draws come from ``generator``."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class ConvBN(nn.Module):
    """conv + BN (+ ReLU), the reference's _ConvBnReLU (deeplabs/resnet.py:26-47)."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, relu: bool = True,
                 bn_momentum: float = 0.999, groups: int = 1, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.relu = relu
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, features, kernel, stride, padding, dilation, groups,
                              bias=use_bias)
        self.bn = BatchNorm(features, bn_momentum)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.bn(conv(x, self.conv, self.dtype), train)
        return F.relu(x) if self.relu else x


def _pool(x: torch.Tensor, window: int, stride: int, padding: int, ceil: bool) -> torch.Tensor:
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding, ceil_mode=ceil)
    return y.permute(0, 2, 3, 1)


def max_pool_ceil(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """torch MaxPool2d(window, stride, padding, ceil_mode=True) on NHWC."""
    return _pool(x, window, stride, padding, True)


def max_pool_floor(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """torch MaxPool2d(window, stride, padding), floor mode, on NHWC."""
    return _pool(x, window, stride, padding, False)


# ---------------------------------------------------------------------------
# Flavour 1: MSRA / Kazuto DeepLab backbone (deeplabs/resnet.py)
# ---------------------------------------------------------------------------


class MSRABottleneck(nn.Module):
    """_Bottleneck (deeplabs/resnet.py:49-70): stride on the reduce 1x1."""

    def __init__(self, cin: int, out_ch: int, stride: int, dilation: int,
                 downsample: bool, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = out_ch // 4
        self.reduce = ConvBN(cin, mid, 1, stride, 0, 1, True, dtype=dtype)
        self.conv3x3 = ConvBN(mid, mid, 3, 1, dilation, dilation, True, dtype=dtype)
        self.increase = ConvBN(mid, out_ch, 1, 1, 0, 1, False, dtype=dtype)
        self.shortcut = (ConvBN(cin, out_ch, 1, stride, 0, 1, False, dtype=dtype)
                         if downsample else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.increase(self.conv3x3(self.reduce(x, train), train), train)
        sc = x if self.shortcut is None else self.shortcut(x, train)
        return F.relu(h + sc)


class MSRAResLayer(nn.Module):
    """_ResLayer with optional multi-grid (deeplabs/resnet.py:73-97)."""

    def __init__(self, n_layers: int, cin: int, out_ch: int, stride: int, dilation: int,
                 multi_grids: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        grids = multi_grids or [1] * n_layers
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"block{i + 1}", MSRABottleneck(
                cin if i == 0 else out_ch, out_ch, stride if i == 0 else 1,
                dilation * grids[i], downsample=(i == 0), dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"block{i + 1}")(x, train)
        return x


class MSRAStem(nn.Module):
    """_Stem: 7x7/2 conv + ceil-mode 3x3/2 max pool (deeplabs/resnet.py:100-107)."""

    def __init__(self, out_ch: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBN(3, out_ch, 7, 2, 3, 1, True, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return max_pool_ceil(self.conv1(x, train), 3, 2, 1)


# ---------------------------------------------------------------------------
# Flavour 2: BECO ResNet-B/C/D (res/modules/backbones/resnet.py)
# ---------------------------------------------------------------------------


class DBottleneck(nn.Module):
    """torchvision-style bottleneck, stride on the 3x3
    (res/modules/backbones/resnet.py:128-180). ``avg_down`` adds the
    ResNet-D 2x2 avg-pool before the shortcut 1x1."""

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False, avg_down: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = planes * 4
        self.pool_shortcut = avg_down and stride != 1
        self.conv1 = ConvBN(cin, planes, 1, 1, 0, 1, True, dtype=dtype)
        self.conv2 = ConvBN(planes, planes, 3, stride, dilation, dilation, True, dtype=dtype)
        self.conv3 = ConvBN(planes, out_ch, 1, 1, 0, 1, False, dtype=dtype)
        self.shortcut = (ConvBN(cin, out_ch, 1, 1 if self.pool_shortcut else stride, 0, 1,
                                False, dtype=dtype) if downsample else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.conv3(self.conv2(self.conv1(x, train), train), train)
        sc = x
        if self.shortcut is not None:
            if self.pool_shortcut:
                sc = F.avg_pool2d(sc.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            sc = self.shortcut(sc, train)
        return F.relu(h + sc)


class ResNetD(nn.Module):
    """BECO get_convnet (res/modules/backbones/resnet.py:341-384):
    ``variety`` resnet-B/C/D, output stride 8 or 16, multi-grid on layer4.
    Returns {0: stem output, 1..4: layer outputs}, like the reference's
    forward dict (``out_indices`` is kept for the JAX signature)."""

    LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3),
              26: (1, 1, 1, 1)}  # 26 = the tiny test entry

    def __init__(self, depth: int = 101, variety: str = "resnet-D", output_stride: int = 16,
                 out_indices: Tuple[int, ...] = (1, 4), contract_dilation: bool = False,
                 multi_grid: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        assert variety in ("resnet-B", "resnet-C", "resnet-D")
        self.out_indices = out_indices
        self.type_c = variety in ("resnet-C", "resnet-D")
        avg_down = variety == "resnet-D"
        if output_stride == 16:
            strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
        else:
            strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
        grids = [1, 2, 4] if multi_grid else None
        if self.type_c:  # the deep stem (HeadLayer_C, :53-81)
            self.stem1 = ConvBN(3, 32, 3, 2, 1, 1, True, dtype=dtype)
            self.stem2 = ConvBN(32, 32, 3, 1, 1, 1, True, dtype=dtype)
            self.stem3 = ConvBN(32, 64, 3, 1, 1, 1, True, dtype=dtype)
        else:
            self.stem1 = ConvBN(3, 64, 7, 2, 3, 1, True, dtype=dtype)
        self.blocks = []
        in_planes = 64
        for li, (planes, n, stride, dil) in enumerate(
                zip((64, 128, 256, 512), self.LAYERS[depth], strides, dilations), start=1):
            if dil != 1:
                stride = 1
            last = li == 4 and grids is not None
            names = []
            for bi in range(n):
                if last:
                    bdil = dil * grids[min(bi, len(grids) - 1)]
                elif bi == 0 and contract_dilation and dil > 1:
                    bdil = dil // 2
                else:
                    bdil = dil
                name = f"layer{li}_block{bi + 1}"
                self.add_module(name, DBottleneck(
                    in_planes, planes, stride=stride if bi == 0 else 1, dilation=bdil,
                    downsample=(bi == 0 and (stride != 1 or in_planes != planes * 4)),
                    avg_down=avg_down, dtype=dtype))
                names.append(name)
                in_planes = planes * 4
            self.blocks.append(names)

    def forward(self, x: torch.Tensor, train: bool = False) -> Dict[int, torch.Tensor]:
        x = self.stem1(x, train)
        if self.type_c:
            x = self.stem3(self.stem2(x, train), train)
        # reference res/modules/backbones/resnet.py:42,66: default floor mode
        x = max_pool_floor(x, 3, 2, 1)
        out = {0: x}
        for li, names in enumerate(self.blocks, start=1):
            for name in names:
                x = getattr(self, name)(x, train)
            out[li] = x
        return out
