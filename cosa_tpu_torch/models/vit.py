"""Vision Transformer encoder, PyTorch.

Port of the JAX package's models/vit.py (itself a twin of the reference's
modified timm encoder): per-block token taps, a *frozen* positional
embedding bicubic-resized to each input grid at every forward, and a
``(cls_token, normed_tokens, aux_tokens)`` return with the aux tap at
``aux_layer``.

Precision follows the JAX package's dtype plumbing with explicit casts
(no autocast): parameters are f32; matmul inputs are cast to ``dtype``
(bf16 under mixed precision); LayerNorms and the attention softmax run in
f32; the residual stream is carried in ``dtype``.

Module and parameter names are the reference's (``patch_embed.proj``,
``blocks.{i}.attn.qkv``, ...), so a CoSA state dict loads with
``load_state_dict``. Tokens are not padded: the attention kernel masks the
ragged edge of the sequence itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cosa_tpu_torch.kernels.attention import attention
from cosa_tpu_torch.ops.resize import resize_bicubic


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    base_img_size: int = 224  # grid the pretrained pos-embed was trained at
    # DeiT distillation token (reference models/vit/deit.py:21-56): the
    # prefix is [dist, cls] and pos_embed has num_patches + 2 rows
    distilled: bool = False


BACKBONES = {
    "vit_base_patch16_224": ViTConfig(),
    "vit_large_patch16_224": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
    "vit_small_patch16_224": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "vit_tiny_test": ViTConfig(embed_dim=64, depth=3, num_heads=4, base_img_size=64),
    "deit_tiny_patch16_224": ViTConfig(embed_dim=192, depth=12, num_heads=3),
    "deit_small_patch16_224": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "deit_base_patch16_224": ViTConfig(),
    "deit_base_patch16_384": ViTConfig(base_img_size=384),
    "deit_tiny_distilled_patch16_224": ViTConfig(
        embed_dim=192, depth=12, num_heads=3, distilled=True),
    "deit_small_distilled_patch16_224": ViTConfig(
        embed_dim=384, depth=12, num_heads=6, distilled=True),
    "deit_base_distilled_patch16_224": ViTConfig(distilled=True),
    "deit_base_distilled_patch16_384": ViTConfig(base_img_size=384, distilled=True),
    "deit_tiny_test_distilled": ViTConfig(
        embed_dim=64, depth=3, num_heads=4, base_img_size=64, distilled=True),
}


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied with its input, weight and bias cast to ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in f32, returning f32."""
    return F.layer_norm(x.to(torch.float32), norm.normalized_shape,
                        norm.weight, norm.bias, norm.eps)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool,
                 dtype: torch.dtype, use_kernel: bool):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hd = x.shape[-1] // self.num_heads
        qkv = dense(x, self.qkv, self.dtype)
        o = attention(qkv, self.num_heads, hd ** -0.5, self.use_kernel)
        return dense(o, self.proj, self.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = dense(x, self.fc1, self.dtype)
        # exact erf GELU in f32 (torch's default); tanh GELU under bf16, as
        # the JAX package chose (its deviation is below bf16's step there)
        x = F.gelu(x, approximate="tanh" if self.dtype == torch.bfloat16 else "none")
        return dense(x, self.fc2, self.dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, use_kernel: bool):
        super().__init__()
        d = cfg.embed_dim
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.attn = Attention(d, cfg.num_heads, cfg.qkv_bias, dtype, use_kernel)
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.norm1).to(self.dtype))
        return x + self.mlp(layer_norm(x, self.norm2).to(self.dtype))


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding as unfold + one matmul. The weight
    keeps the reference's conv layout ``proj.weight (D, 3, P, P)``."""

    def __init__(self, embed_dim: int, patch_size: int, dtype: torch.dtype):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) -> (B, gh*gw, D)."""
        p = self.patch_size
        b, h, w, c = x.shape
        gh, gw = h // p, w // p
        # stride-p VALID conv semantics: trailing partial rows/cols drop
        # (e.g. 448 * 0.7 = 313 at a TTA scale)
        x = x[:, : gh * p, : gw * p]
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c)
        wmat = self.proj.weight.permute(2, 3, 1, 0).reshape(p * p * c, -1)
        return x.to(self.dtype) @ wmat.to(self.dtype) + self.proj.bias.to(self.dtype)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig, aux_layer: int = -3,
                 dtype: torch.dtype = torch.float32, use_kernel: bool = False):
        super().__init__()
        self.cfg = cfg
        self.aux_layer = aux_layer
        self.dtype = dtype
        gs = cfg.base_img_size // cfg.patch_size
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(d, cfg.patch_size, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.npre = 2 if cfg.distilled else 1  # prefix tokens
        if cfg.distilled:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, d))
        # frozen (reference vit.py:236-237): no gradient, no optimizer group,
        # but the EMA teacher still tracks it
        self.pos_embed = nn.Parameter(torch.zeros(1, gs * gs + self.npre, d),
                                      requires_grad=False)
        self.blocks = nn.ModuleList(
            [Block(cfg, dtype, use_kernel) for _ in range(cfg.depth)]
        )
        self.norm = nn.LayerNorm(d, eps=cfg.ln_eps)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) float. Returns (cls_token, tokens, aux_tokens)."""
        c = self.cfg
        b, hh, ww, _ = x.shape
        gh, gw = hh // c.patch_size, ww // c.patch_size
        gs = c.base_img_size // c.patch_size
        d = c.embed_dim
        npre = self.npre

        tok = self.patch_embed(x)
        patch_pos = self.pos_embed[:, npre:].reshape(1, gs, gs, d)
        patch_pos = resize_bicubic(patch_pos, (gh, gw)).reshape(1, gh * gw, d)
        pos = torch.cat([self.pos_embed[:, :npre], patch_pos], dim=1)
        # DeiT-distilled prepends [dist, cls], dist first (deit.py:44)
        prefix = [self.dist_token, self.cls_token] if c.distilled else [self.cls_token]
        prefix = torch.cat(prefix, dim=1).expand(b, npre, d).to(self.dtype)
        tok = torch.cat([prefix, tok], dim=1) + pos.to(self.dtype)

        aux_idx = c.depth + self.aux_layer if self.aux_layer < 0 else self.aux_layer
        aux_tokens: Optional[torch.Tensor] = None
        for i, blk in enumerate(self.blocks):
            tok = blk(tok)
            if i == aux_idx:
                aux_tokens = tok
        tok = layer_norm(tok, self.norm).to(self.dtype)
        if aux_tokens is None:  # aux tap at the final (normed) layer
            aux_tokens = tok
        # CLS is the last prefix token ([dist, cls, patches] for DeiT)
        return tok[:, npre - 1], tok[:, npre:], aux_tokens[:, npre:]
