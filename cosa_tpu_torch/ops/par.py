"""PAR: pixel-adaptive refinement (local affinity propagation).

Port of the JAX package's ops/par.py, the twin of the reference's
models/PAR.py:26-91: 8-neighbour affinities at a set of dilations, built
from RGB differences plus a fixed positional prior, propagate mask
probabilities over ``num_iter`` sweeps. Each neighbour is a view into one
replicate-padded copy of the map (padded once per sweep at the largest
dilation), and a sweep sums the 8 * len(dilations) shifted products in the
JAX package's offset order, one in-place multiply-add each: no (B, C, K, H,
W) tensor is made for the mask update. The reference ships PAR but never
enables it (SURVEY.md §2.9); here it is the ``usepar`` refine step of
:func:`cosa_tpu_torch.objectives.pseudo.cam2mask`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cosa_tpu_torch.ops.resize import resize_bilinear_ac

# 8-neighbourhood offsets, in the reference's kernel order (PAR.py:10-24)
_OFFSETS: Tuple[Tuple[int, int], ...] = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 1),
    (1, -1), (1, 0), (1, 1),
)
# sqrt(2) for the diagonal kernels (PAR.py:54-58)
_DIST = np.array([np.sqrt(2), 1, np.sqrt(2), 1, 1, np.sqrt(2), 1, np.sqrt(2)])


def _offsets(dilations: Sequence[int]):
    return [(dy * d, dx * d) for d in dilations for (dy, dx) in _OFFSETS]


def _neighbours(x: torch.Tensor, offsets):
    """Views out[y, x] = x[y + dy, x + dx] of an NCHW map, edges replicated."""
    h, w = x.shape[-2:]
    p = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
    xp = F.pad(x, (p, p, p, p), mode="replicate")
    return [xp[:, :, p + dy:p + dy + h, p + dx:p + dx + w] for dy, dx in offsets]


def _affinity(imgs: torch.Tensor, dilations: Sequence[int], w1: float,
              w2: float) -> torch.Tensor:
    """(B, 3, H, W) images -> (B, K, H, W) normalized affinities."""
    neigh = torch.stack(_neighbours(imgs, _offsets(dilations)), dim=2)  # (B, 3, K, H, W)
    k = neigh.shape[2]
    diff = (neigh - imgs[:, :, None]).abs()
    mean = neigh.mean(dim=2, keepdim=True)
    std = torch.sqrt(((neigh - mean) ** 2).sum(dim=2, keepdim=True) / (k - 1))  # torch.std
    aff = (-((diff / (std + 1e-8) / w1) ** 2)).mean(dim=1)  # (B, K, H, W)

    pos = torch.tensor(np.concatenate([_DIST * d for d in dilations]),
                       dtype=torch.float32, device=imgs.device)
    pos_std = torch.sqrt(((pos - pos.mean()) ** 2).sum() / (k - 1))
    pos_aff = -((pos / (pos_std + 1e-8) / w1) ** 2)
    return torch.softmax(aff, dim=1) + w2 * torch.softmax(pos_aff, dim=0)[None, :, None, None]


def par_affinity(imgs: torch.Tensor, dilations: Sequence[int] = (1, 2, 4, 8, 12, 24),
                 w1: float = 0.3, w2: float = 0.01) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, H, W, K) normalized affinities,
    K = 8 * len(dilations) (reference PAR.py:64-85)."""
    return _affinity(imgs.permute(0, 3, 1, 2), dilations, w1, w2).permute(0, 2, 3, 1)


def par_refine(imgs: torch.Tensor, masks: torch.Tensor,
               dilations: Sequence[int] = (1, 2, 4, 8, 12, 24), num_iter: int = 10,
               w1: float = 0.3, w2: float = 0.01) -> torch.Tensor:
    """Refine (B, h, w, C) mask probabilities against (B, H, W, 3) images
    (reference PAR.forward, models/PAR.py:64-91) -> (B, H, W, C)."""
    masks = resize_bilinear_ac(masks, imgs.shape[1:3])
    aff = _affinity(imgs.permute(0, 3, 1, 2), dilations, w1, w2)
    offsets = _offsets(dilations)
    m = masks.permute(0, 3, 1, 2)
    for _ in range(num_iter):
        out = torch.zeros_like(m, memory_format=torch.contiguous_format)
        for k, shifted in enumerate(_neighbours(m, offsets)):
            out.addcmul_(shifted, aff[:, k:k + 1])
        m = out
    return m.permute(0, 2, 3, 1)
