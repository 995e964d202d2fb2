"""Segmentation decoders, NHWC at the interface.

``LargeFOV`` — DeepLab-LargeFOV (reference models/decoder/conv_head.py:11-41):
two 3x3 dilation-5 512-channel convs and a 1x1, all bias-free, ReLU
between; NCHW only inside the convolutions.

``MaskTransformer`` — the Segmenter-style mask transformer (reference
models/decoder/maskformer_head.py:99-164; the JAX package's
models/decoders.py:53-173): 2 blocks over the projected patch tokens and
the class embeddings, then normalized patch x class dot-product masks.
Its blocks are the encoder's ``Block`` with the plain attention (the JAX
package leaves this attention to XLA, not to a Pallas kernel), head width
64, MLP 4 x d_model and torch's default LayerNorm eps 1e-5. Module names
are the reference's, so a Maskformer ``.pth`` loads with
``load_state_dict``.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from cosa_tpu_torch.models.vit import Block, ViTConfig, dense, layer_norm


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


class MaskTransformer(nn.Module):
    """``multi=True`` is the reference's MultiMaskTransformer
    (maskformer_head.py:167-235): it also emits masks from the penultimate
    block through the same mask head and returns (masks_pen, masks_final)."""

    N_LAYERS = 2
    LN_EPS = 1e-5  # torch's default: the reference head builds plain nn.LayerNorm

    def __init__(self, n_cls: int, patch_size: int, d_encoder: int, d_model: int,
                 multi: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_cls = n_cls
        self.patch_size = patch_size
        self.multi = multi
        self.dtype = dtype
        block_cfg = ViTConfig(embed_dim=d_model, num_heads=d_model // 64, mlp_ratio=4.0,
                              qkv_bias=True, ln_eps=self.LN_EPS)
        self.proj_dec = nn.Linear(d_encoder, d_model)
        self.cls_emb = nn.Parameter(torch.zeros(1, n_cls, d_model))
        self.blocks = nn.ModuleList(
            [Block(block_cfg, dtype, use_kernel=False) for _ in range(self.N_LAYERS)])
        self.proj_patch = nn.Parameter(torch.zeros(d_model, d_model))
        self.proj_classes = nn.Parameter(torch.zeros(d_model, d_model))
        self.decoder_norm = nn.LayerNorm(d_model, eps=self.LN_EPS)
        self.mask_norm = nn.LayerNorm(n_cls, eps=self.LN_EPS)

    def _masks(self, x: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        """The shared mask head: (B, N + n_cls, d_model) -> (B, gh, gw, n_cls) f32."""
        dt = self.dtype
        x = layer_norm(x, self.decoder_norm).to(dt)
        patches, cls_feat = x[:, :-self.n_cls], x[:, -self.n_cls:]
        patches = patches @ self.proj_patch.to(dt)
        cls_feat = cls_feat @ self.proj_classes.to(dt)
        patches = patches / torch.linalg.vector_norm(
            patches.float(), dim=-1, keepdim=True).to(dt)
        cls_feat = cls_feat / torch.linalg.vector_norm(
            cls_feat.float(), dim=-1, keepdim=True).to(dt)
        masks = torch.einsum("bnd,bcd->bnc", patches, cls_feat)
        masks = layer_norm(masks, self.mask_norm)
        return masks.reshape(x.shape[0], gh, gw, self.n_cls)

    def forward(self, tokens: torch.Tensor, im_size: Tuple[int, int]
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """tokens: (B, N, D_enc) patch tokens of an (H, W) input ->
        (B, gh, gw, n_cls) f32 masks (a pair of them when ``multi``)."""
        b, n, _ = tokens.shape
        gh = im_size[0] // self.patch_size
        gw = n // gh
        x = dense(tokens, self.proj_dec, self.dtype)
        cls = self.cls_emb.expand(b, -1, -1).to(self.dtype)
        x = torch.cat([x, cls], dim=1)
        for blk in self.blocks[:-1]:
            x = blk(x)
        x_pen = x
        x = self.blocks[-1](x_pen)
        if self.multi:
            return self._masks(x_pen, gh, gw), self._masks(x, gh, gw)
        return self._masks(x, gh, gw)
