"""Swin Transformer backbone + SwinNetwork (the full CoSA co-training
interface), PyTorch.

Port of the JAX package's models/zoo/swin.py (the reference's vestigial
'swinend2end' branch, models/mmsegmodel/__init__.py:77-350, rebuilt
mmcv-free). NHWC throughout, as there:

  * the window partition is a reshape + permute;
  * the relative-position index (kernels/window_attn.py) and the
    shifted-window / padding mask are computed with numpy once per static
    shape and cached on the device (they are constants, not buffers: the
    state dict's keys stay the JAX tree's leaves);
  * inputs are padded up to window multiples and pad keys are masked with
    the same additive -1e4 mask as the shifted windows.

Module and parameter names are the JAX tree's (``stage{i}_block{j}``,
``merge{i}``, ``attn.rel_pos_bias``, ...), so ``state_dict_from_jax``
carries a JAX tree over by renaming leaves. The window attention's core,
from the scores through the bias, the mask and the softmax to the product
with v, is kernel K6 on the card and its plain version on the CPU
(``kernels/window_attn.py``); both round in the JAX order (scores in the
compute dtype, then f32 for the bias, mask and softmax), which
``F.scaled_dot_product_attention`` would not keep. The core runs under the
span ``window_attn`` (``utils/trace.py``), and :data:`WINDOW_ATTN` counts
its calls.

Stochastic depth (:class:`DropPath`) draws from the ``generator`` the
caller passes; the train step seeds it from ``(cfg.seed, step)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cosa_tpu_torch.kernels.window_attn import window_attention
from cosa_tpu_torch.models.decoders import LargeFOV
from cosa_tpu_torch.models.network import cosa_heads
from cosa_tpu_torch.models.vit import dense, layer_norm, row_dense
from cosa_tpu_torch.parallel.tensor import copy_to_tp, group_rank, group_size
from cosa_tpu_torch.utils.trace import span

# host-side counts of WindowAttention's calls, the windows they attend
# (batch x windows, this rank's rows) and the calls that carry a shift or
# pad mask: plain int increments, no device sync
WINDOW_ATTN = {"calls": 0, "windows": 0, "masked_calls": 0}


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    patch_size: int = 4
    mlp_ratio: int = 4
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    ln_eps: float = 1e-5  # torch nn.LayerNorm default (mmcv 'LN')

    def widths(self) -> List[int]:
        """The channel width after each block, in block order."""
        return [self.embed_dim * 2 ** si for si, d in enumerate(self.depths)
                for _ in range(d)]


# mmsegmodel/swin_{t,s,b}.py configs
SWIN_CONFIGS = {
    "swin-t": SwinConfig(),
    "swin-s": SwinConfig(depths=(2, 2, 18, 2)),
    "swin-b": SwinConfig(embed_dim=128, depths=(2, 2, 18, 2),
                         num_heads=(4, 8, 16, 32), drop_path_rate=0.3),
    "swin_tiny_test": SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                                 num_heads=(1, 2, 4, 8), window=4,
                                 drop_path_rate=0.0),
    # every stage's heads split over 2 model ranks (the tensor-parallel tests)
    "swin_tp_test": SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                               num_heads=(2, 2, 4, 8), window=4,
                               drop_path_rate=0.0),
}


def _shift_mask(hp: int, wp: int, w: int, shift: int,
                h_valid: int, w_valid: int) -> np.ndarray:
    """Additive (nW, w^2, w^2) mask: -1e4 across shifted-window region
    boundaries AND for padded key positions; 0 elsewhere."""
    ids = np.zeros((hp, wp), np.int32)
    if shift > 0:
        cnt = 0
        slices = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
        for hs in slices:
            for ws in slices:
                ids[hs, ws] = cnt
                cnt += 1
    # the region ids are post-roll (the official Swin img_mask), so the
    # pre-roll pad band is rolled with the data before it is marked
    pad = np.zeros((hp, wp), bool)
    pad[h_valid:, :] = True
    pad[:, w_valid:] = True
    if shift > 0:
        pad = np.roll(pad, (-shift, -shift), axis=(0, 1))
    ids[pad] = -1  # padding: always masked as keys
    win = ids.reshape(hp // w, w, wp // w, w).transpose(0, 2, 1, 3)
    win = win.reshape(-1, w * w)
    same = win[:, :, None] == win[:, None, :]
    key_pad = (win == -1)[:, None, :]
    return np.where(same & ~key_pad, 0.0, -1e4).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _device_const(fn, args: tuple, device: torch.device) -> torch.Tensor:
    """``fn(*args)`` (a numpy constant of a static shape) on ``device``,
    computed once per shape and device."""
    return torch.from_numpy(fn(*args)).to(device)


class DropPath(nn.Module):
    """Stochastic depth: per sample, the residual branch is dropped with
    probability ``p`` and a kept branch is scaled by 1/(1 - p) (timm's
    DropPath; the JAX package's nn.Dropout with broadcast_dims (1, 2, 3)).
    Live only with ``train``; the draws come from ``generator``."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        # (this rank's data index, data ranks): the draw covers the global
        # batch and this rank keeps its rows (parallel/mesh.py::shard_module_)
        self.rows = (0, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.p
        b, (r, n) = x.shape[0], self.rows
        shape = (b * n,) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator, device=x.device)[r * b:(r + 1) * b] < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class WindowAttention(nn.Module):
    """Window attention with a learned relative-position bias. Under tensor
    parallelism (``tp_group`` set) this rank holds its heads' rows of q, k
    and v and their columns of proj; the replicated bias table is read at
    its heads' columns, and its gradient is summed over the group."""

    TP_LAYERS, TP_UNIT = ("qkv", "proj"), "heads"

    def __init__(self, dim: int, num_heads: int, window: int, qkv_bias: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = self.tp_units = num_heads
        self.window = window
        self.dtype = dtype
        self.tp_group = None
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.rel_pos_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, xw: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """xw: (B*nW, w^2, C); mask: (nW, w^2, w^2) additive or None."""
        bn, n, c = xw.shape
        g = self.tp_group
        hd = c // self.num_heads
        h = self.num_heads // group_size(g)
        qkv = dense(copy_to_tp(xw, g), self.qkv, self.dtype).reshape(bn, n, 3, h, hd)
        WINDOW_ATTN["calls"] += 1
        WINDOW_ATTN["windows"] += bn
        WINDOW_ATTN["masked_calls"] += mask is not None
        with span("window_attn"):
            table = copy_to_tp(self.rel_pos_bias, g)
            if g is not None:
                table = table[:, group_rank(g) * h:(group_rank(g) + 1) * h]
            o = window_attention(qkv, table, self.window, mask)
        return row_dense(o, self.proj, self.dtype, g)


class SwinBlock(nn.Module):
    """Under tensor parallelism (``tp_group`` set) this rank holds its share
    of the MLP's hidden width (fc1's rows, fc2's columns)."""

    TP_LAYERS, TP_UNIT = ("fc1", "fc2"), "hidden channels"

    def __init__(self, dim: int, num_heads: int, window: int, shift: int, mlp_ratio: int,
                 qkv_bias: bool, drop_path: float, ln_eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window = window
        self.shift = shift
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = WindowAttention(dim, num_heads, window, qkv_bias, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim)
        self.tp_units = dim * mlp_ratio
        self.tp_group = None
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, hh, ww, c = x.shape
        w = self.window
        hp, wp = -(-hh // w) * w, -(-ww // w) * w
        shift = self.shift if min(hp, wp) > w else 0  # a single window: no shift

        y = layer_norm(x, self.norm1).to(self.dtype)
        if (hp, wp) != (hh, ww):
            y = F.pad(y, (0, 0, 0, wp - ww, 0, hp - hh))
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        # windows: (B, nH, w, nW, w, C) -> (B*nWin, w^2, C)
        y = y.reshape(b, hp // w, w, wp // w, w, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)
        need_mask = shift > 0 or (hp, wp) != (hh, ww)
        mask = (_device_const(_shift_mask, (hp, wp, w, shift, hh, ww), x.device)
                if need_mask else None)
        y = self.attn(y, mask)
        y = y.reshape(b, hp // w, wp // w, w, w, c)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        y = y[:, :hh, :ww]
        x = x + self.drop_path(y, train, generator)

        y = layer_norm(x, self.norm2).to(self.dtype)
        y = dense(copy_to_tp(y, self.tp_group), self.fc1, self.dtype)
        y = F.gelu(y, approximate="tanh" if self.dtype == torch.bfloat16 else "none")
        y = row_dense(y, self.fc2, self.dtype, self.tp_group)
        return x + self.drop_path(y, train, generator)


class PatchMerging(nn.Module):
    """2x2 space-to-depth + LayerNorm + a bias-free 4C -> 2C dense (mmcv
    PatchMerging)."""

    def __init__(self, dim: int, ln_eps: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=ln_eps)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        if hh % 2 or ww % 2:
            x = F.pad(x, (0, 0, 0, ww % 2, 0, hh % 2))
            hh, ww = x.shape[1], x.shape[2]
        x = x.reshape(b, hh // 2, 2, ww // 2, 2, c)
        # mmcv flattens each 2x2 block with nn.Unfold, whose feature order
        # is CHANNEL-major: index = c*4 + (row*2 + col), so mmseg Swin
        # checkpoints map 1:1 onto `reduction`
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, hh // 2, ww // 2, 4 * c)
        return dense(layer_norm(x, self.norm), self.reduction, self.dtype)


class SwinBackbone(nn.Module):
    """4-stage Swin; returns (the normed stage outputs of ``out_indices``,
    every block's NHWC map), like the reference's SwinTransformer_
    (mmsegmodel/__init__.py:297-320)."""

    def __init__(self, cfg: SwinConfig, out_indices: Sequence[int] = (0, 1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.out_indices = tuple(out_indices)
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, c.embed_dim, c.patch_size, stride=c.patch_size)
        self.patch_norm = nn.LayerNorm(c.embed_dim, eps=c.ln_eps)
        total = sum(c.depths)
        dpr = [c.drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        cur = 0
        for si, depth in enumerate(c.depths):
            dim = c.embed_dim * 2 ** si
            for bi in range(depth):
                self.add_module(f"stage{si}_block{bi}", SwinBlock(
                    dim, c.num_heads[si], c.window, 0 if bi % 2 == 0 else c.window // 2,
                    c.mlp_ratio, c.qkv_bias, dpr[cur + bi], c.ln_eps, dtype))
            cur += depth
            if si in self.out_indices:
                self.add_module(f"norm{si}", nn.LayerNorm(dim, eps=c.ln_eps))
            if si < len(c.depths) - 1:
                self.add_module(f"merge{si}", PatchMerging(dim, c.ln_eps, dtype))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        c = self.cfg
        p = c.patch_size
        hh, ww = x.shape[1:3]
        if hh % p or ww % p:  # mmcv 'corner' padding
            x = F.pad(x, (0, 0, 0, -ww % p, 0, -hh % p))
        dt = self.dtype
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=p).permute(0, 2, 3, 1)
        x = layer_norm(x, self.patch_norm).to(dt)
        outs, blocks = [], []
        for si, depth in enumerate(c.depths):
            for bi in range(depth):
                x = getattr(self, f"stage{si}_block{bi}")(x, train, generator)
                blocks.append(x)
            if si in self.out_indices:
                outs.append(layer_norm(x, getattr(self, f"norm{si}")).to(dt))
            if si < len(c.depths) - 1:
                x = getattr(self, f"merge{si}")(x)
        return outs, blocks


class SwinNetwork(nn.Module):
    """The MMSWIN equivalent (mmsegmodel/__init__.py:77-175): Swin backbone
    + LargeFOV seg decoder + bias-free CAM/cls heads on the last stage and
    on the ``aux_layer``-indexed block (a negative index into the flat
    per-block list, whose widths follow the stage schedule). Returns the
    dict of ``CoSANetwork``, so the co-training step, the TTA fuse and the
    evaluation run unchanged. ``detach`` routes as in CoSANetwork ('none'
    is the reference's behaviour: MMSWIN ignores it)."""

    def __init__(self, num_classes: int, backbone: str = "swin-t", aux_layer: int = -3,
                 isgap: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = SWIN_CONFIGS[backbone]
        self.aux_layer = aux_layer
        self.isgap = isgap
        self.dtype = dtype
        self.backbone = SwinBackbone(cfg, (3,), dtype)
        widths = cfg.widths()
        d, d_aux = widths[-1], widths[aux_layer]
        self.decoder = LargeFOV(d, num_classes, dtype=dtype)
        self.classifier = nn.Conv2d(d, num_classes - 1, 1, bias=False)
        self.aux_classifier = nn.Conv2d(d_aux, num_classes - 1, 1, bias=False)

    def forward(self, x: torch.Tensor, detach: str = "none", train: bool = False,
                generator: Optional[torch.Generator] = None,
                quant: bool = False) -> Dict[str, torch.Tensor]:
        """``train=True`` makes the backbone's stochastic depth live (the
        reference MMSWIN trains with drop_path 0.1-0.3), drawing from
        ``generator``; the teacher and evaluation keep the default. The
        int8 teacher is ViT-only: ``quant`` raises."""
        if quant:
            raise NotImplementedError("quant: the int8 teacher twin is ViT-only")
        outs, blocks = self.backbone(x, train, generator)
        fmap = outs[-1]
        seg = self.decoder(fmap)
        return cosa_heads(fmap, blocks[self.aux_layer], seg, self.classifier,
                          self.aux_classifier, self.dtype, detach, self.isgap)
