"""On-device high-dimensional Gaussian (bilateral) filtering.

``AS = G @ values`` with ``G_ij = exp(-||f_i - f_j||^2 / 2)`` over 5-D
pixel features. The training path uses the random-Fourier-feature (RFF)
factorization G ~= Phi Phi^T, Phi = sqrt(2/D) cos(f W + b), so
``G @ V ~= Phi @ (Phi^T @ V)``: the embedding Phi is kernel K3
(kernels/rff.py) and the two products are ordinary bf16 matmuls with f32
accumulation, as in the JAX package, which left them to XLA.
:func:`exact_gaussian_filter` is the brute-force oracle.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from cosa_tpu_torch.kernels.rff import rff_phi


def pixel_features(image: torch.Tensor, sigma_rgb: float, sigma_xy: float) -> torch.Tensor:
    """(B, H, W, 3) 0-255 image -> (B, H, W, 5) bilateral features
    (x, y, r, g, b) (reference bilateralfilter.cpp:4-19)."""
    b, h, w, _ = image.shape
    dev = image.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None].expand(b, h, w, 1)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None].expand(b, h, w, 1)
    return torch.cat(
        [xs / sigma_xy, ys / sigma_xy, image.to(torch.float32) / sigma_rgb], dim=-1
    )


@functools.lru_cache(maxsize=16)
def _rff_params(n_features: int, dim: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Orthogonal random features (Yu et al., 2016): blocks of the Gaussian
    projection are orthogonalized and rescaled by chi-distributed norms —
    same expectation as plain RFF, measurably lower variance."""
    rng = np.random.default_rng(seed)
    blocks = []
    remaining = n_features
    while remaining > 0:
        g = rng.standard_normal((dim, dim))
        q, _ = np.linalg.qr(g)
        norms = np.linalg.norm(rng.standard_normal((dim, dim)), axis=1)
        blocks.append(q * norms[None, :])
        remaining -= dim
    w = np.concatenate(blocks, axis=1)[:, :n_features].astype(np.float32)
    b = rng.uniform(0.0, 2.0 * np.pi, size=(n_features,)).astype(np.float32)
    return w, b


def rff_embed(features: torch.Tensor, n_features: int = 256, seed: int = 0,
              dtype=torch.float32) -> torch.Tensor:
    """(B, N, dim) features -> (B, N, D) random Fourier embedding.

    The phase is always f32 (phases span tens of radians; bf16 would alias
    them); ``dtype`` is the stored precision, bf16 or f32. Every call goes
    through kernel K3's wrapper, which takes the plain version only for a
    CPU tensor."""
    w_np, b_np = _rff_params(n_features, features.shape[-1], seed)
    w = torch.from_numpy(w_np).to(features.device)
    b = torch.from_numpy(b_np).to(features.device)
    scale = float(np.sqrt(2.0 / n_features))
    return rff_phi(features.to(torch.float32).contiguous(), w, b, scale, dtype)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b accumulated and returned in f32. On the GPU, bf16
    operands go to cuBLAS as they are (bf16 products, f32 output); the CPU
    has no such product, so there they are upcast first. bf16 values are
    exact in f32, so both give the f32-accumulated product of the bf16
    values."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def rff_gaussian_filter(features: torch.Tensor, values: torch.Tensor,
                        n_features: int = 256, seed: int = 0,
                        dtype=torch.float32) -> torch.Tensor:
    """AS ~= G @ values. features (B, N, dim); values (B, N, K) -> (B, N, K)
    f32. ``dtype`` is the embedding/matmul-operand precision."""
    phi = rff_embed(features, n_features, seed, dtype)  # (B, N, D)
    coeff = _matmul_f32(phi.transpose(1, 2), values.to(dtype))  # (B, D, K)
    return _matmul_f32(phi, coeff.to(dtype))


def exact_gaussian_filter(features: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Brute-force O(N^2) oracle: G @ values. Small inputs only."""
    d2 = ((features[:, :, None, :] - features[:, None, :, :]) ** 2).sum(dim=-1)
    return torch.bmm(torch.exp(-0.5 * d2), values)
