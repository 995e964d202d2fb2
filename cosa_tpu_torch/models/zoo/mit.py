"""MixVisionTransformer (the SegFormer backbone) + SegFormerHead, PyTorch,
NHWC at every interface.

Port of the JAX package's models/zoo/mit.py (the reference's vestigial
SegFormer stack, models/vit/mix_transformer.py:18-439 and
models/decoder/segformer_head.py:26-81). Spatial-reduction attention is
plain PyTorch (the JAX package leaves it to XLA): keys and values come
from an sr x sr strided conv of the map, so the scores are (N, N/sr^2).

The JAX package gives that conv flax's default "SAME" padding. Where the
grid is not a multiple of sr (125 at a 500 input with sr 8), SAME pads
ceil(n/sr)*sr - n in all, half (rounded down) before and the rest after;
:func:`_same_pad` does so explicitly (torch's padding=0 would drop the
partial window). Module names are the JAX tree's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cosa_tpu_torch.models.vit import dense, layer_norm
from cosa_tpu_torch.models.zoo.resnet import BatchNorm, Dropout, conv
from cosa_tpu_torch.models.zoo.swin import DropPath
from cosa_tpu_torch.ops.resize import resize_bilinear

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MiTConfig:
    embed_dims: Tuple[int, ...] = (64, 128, 320, 512)
    depths: Tuple[int, ...] = (3, 4, 6, 3)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    mlp_ratios: Tuple[int, ...] = (4, 4, 4, 4)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    strides: Tuple[int, ...] = (4, 2, 2, 2)
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    ln_eps: float = 1e-6


# mix_transformer.py:394-439 (mit_b0..b5); the tiny entry keeps tests fast
MIT_CONFIGS = {
    "mit_b0": MiTConfig(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2)),
    "mit_b1": MiTConfig(depths=(2, 2, 2, 2)),
    "mit_b2": MiTConfig(depths=(3, 4, 6, 3)),
    "mit_b3": MiTConfig(depths=(3, 4, 18, 3)),
    "mit_b4": MiTConfig(depths=(3, 8, 27, 3)),
    "mit_b5": MiTConfig(depths=(3, 6, 40, 3)),
    "mit_tiny_test": MiTConfig(
        embed_dims=(16, 32, 64, 128), depths=(1, 1, 1, 1),
        num_heads=(1, 2, 4, 8), drop_path_rate=0.0,
    ),
}


def _same_pad(x: torch.Tensor, k: int) -> torch.Tensor:
    """flax "SAME" padding of an NHWC map for a k x k conv at stride k."""
    pads = []
    for n in (x.shape[2], x.shape[1]):  # F.pad lists the last dims first
        total = -(-n // k) * k - n
        pads += [total // 2, total - total // 2]
    return F.pad(x, [0, 0] + pads) if any(pads) else x


class SRAttention(nn.Module):
    """Spatial-reduction attention (mix_transformer.py:56-133)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int, qkv_bias: bool,
                 ln_eps: float, dtype: torch.dtype = F32):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.dtype = dtype
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_norm = nn.LayerNorm(dim, eps=ln_eps)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        q = dense(x, self.q, self.dtype).reshape(b, h * w, nh, hd)
        if self.sr_ratio > 1:
            kv_in = conv(_same_pad(x, self.sr_ratio), self.sr, self.dtype)
            kv_in = layer_norm(kv_in, self.sr_norm).to(self.dtype)
        else:
            kv_in = x
        m = kv_in.shape[1] * kv_in.shape[2]
        kv = dense(kv_in.reshape(b, m, c), self.kv, self.dtype).reshape(b, m, 2, nh, hd)
        k, v = kv[:, :, 0], kv[:, :, 1]
        s = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
        p = torch.softmax(s.float(), dim=-1).to(self.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, h * w, c)
        return dense(o, self.proj, self.dtype).reshape(b, h, w, c)


class MixFFN(nn.Module):
    """MLP with a 3x3 depthwise conv between fc1 and the GELU
    (mix_transformer.py:18-53 + DWConv :381-392)."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv(dense(x, self.fc1, self.dtype), self.dwconv, self.dtype)
        x = F.gelu(x, approximate="tanh" if self.dtype == torch.bfloat16 else "none")
        return dense(x, self.fc2, self.dtype)


class MiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int, sr_ratio: int,
                 qkv_bias: bool, drop_path: float, ln_eps: float, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias, ln_eps, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = MixFFN(dim, dim * mlp_ratio, dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.attn(layer_norm(x, self.norm1).to(self.dtype))
        x = x + self.drop_path(y, train, generator)
        y = self.mlp(layer_norm(x, self.norm2).to(self.dtype))
        return x + self.drop_path(y, train, generator)


class MixVisionTransformer(nn.Module):
    """The 4-stage pyramid ViT; returns the 4 NHWC stage maps in f32
    (mix_transformer.py:219-378 forward_features)."""

    def __init__(self, cfg: MiTConfig, dtype: torch.dtype = F32):
        super().__init__()
        self.cfg = c = cfg
        self.dtype = dtype
        total = sum(c.depths)
        dpr = [c.drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        cin, cur = 3, 0
        for si in range(4):
            patch = 7 if si == 0 else 3
            s, dim = si + 1, c.embed_dims[si]
            self.add_module(f"patch_embed{s}", nn.Conv2d(
                cin, dim, patch, stride=c.strides[si], padding=patch // 2))
            self.add_module(f"patch_norm{s}", nn.LayerNorm(dim, eps=c.ln_eps))
            for bi in range(c.depths[si]):
                self.add_module(f"block{s}_{bi}", MiTBlock(
                    dim, c.num_heads[si], c.mlp_ratios[si], c.sr_ratios[si], c.qkv_bias,
                    dpr[cur + bi], c.ln_eps, dtype))
            cur += c.depths[si]
            self.add_module(f"norm{s}", nn.LayerNorm(dim, eps=c.ln_eps))
            cin = dim

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        outs = []
        for si in range(4):
            s = si + 1
            x = conv(x, getattr(self, f"patch_embed{s}"), self.dtype)
            x = layer_norm(x, getattr(self, f"patch_norm{s}"))
            for bi in range(self.cfg.depths[si]):
                x = getattr(self, f"block{s}_{bi}")(x.to(self.dtype), train, generator)
            x = layer_norm(x, getattr(self, f"norm{s}"))
            outs.append(x)
        return tuple(outs)


class SegFormerHead(nn.Module):
    """The all-MLP fuse head (segformer_head.py:26-81), mmcv-free: each
    stage map linearly embedded, bilinear-upsampled to the stage-1 grid,
    concatenated, fused by 1x1 conv + BN + ReLU, and classified."""

    def __init__(self, in_dims: Sequence[int], num_classes: int, embedding_dim: int = 256,
                 dropout: float = 0.1, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        for i, d in enumerate(in_dims):
            self.add_module(f"linear_c{i + 1}", nn.Linear(d, embedding_dim))
        self.linear_fuse = nn.Conv2d(4 * embedding_dim, embedding_dim, 1, bias=False)
        self.fuse_bn = BatchNorm(embedding_dim, momentum=0.9)
        self.drop = Dropout(dropout)
        self.linear_pred = nn.Conv2d(embedding_dim, num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tgt = tuple(feats[0].shape[1:3])
        embs = []
        # the reference fuses in the order [c4, c3, c2, c1] (segformer_head.py:77)
        for i in (3, 2, 1, 0):
            e = dense(feats[i], getattr(self, f"linear_c{i + 1}"), self.dtype)
            if tuple(e.shape[1:3]) != tgt:
                e = resize_bilinear(e.to(F32), tgt).to(self.dtype)
            embs.append(e)
        x = conv(torch.cat(embs, dim=-1), self.linear_fuse, self.dtype)
        x = self.drop(F.relu(self.fuse_bn(x, train)), train, generator)
        return conv(x, self.linear_pred, F32)


class SegFormer(nn.Module):
    """MiT backbone + SegFormerHead: logits at the stage-1 (1/4) grid."""

    def __init__(self, num_classes: int, backbone: str = "mit_b1", dtype: torch.dtype = F32):
        super().__init__()
        cfg = MIT_CONFIGS[backbone]
        self.encoder = MixVisionTransformer(cfg, dtype)
        self.decoder = SegFormerHead(cfg.embed_dims, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decoder(self.encoder(x, train, generator), train, generator)
