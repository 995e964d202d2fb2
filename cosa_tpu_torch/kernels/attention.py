"""Attention dispatch for the ViT encoder.

``use_kernel=True`` (``cfg.flash_attention``, the default) runs the
hand-written kernels K1/K2 on a CUDA tensor; on a CPU tensor their wrapper
takes the plain version. ``use_kernel=False`` is the user's explicit choice
of the plain softmax(QK^T)V path, as the einsum path is in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from cosa_tpu_torch.kernels.flash import flash_attention_qkv, plain_attention_qkv


def attention(qkv: torch.Tensor, num_heads: int, scale: float,
              use_kernel: bool, n_valid: Optional[int] = None) -> torch.Tensor:
    """qkv (B, N, 3*C) packed projection -> (B, N, C)."""
    if use_kernel:
        return flash_attention_qkv(qkv, num_heads, scale, n_valid)
    return plain_attention_qkv(qkv, num_heads, scale, n_valid)
