"""Torch-parity image resizing on NHWC tensors.

The public functions keep the JAX package's NHWC layout; each converts to
NCHW only around ``F.interpolate(align_corners=False, antialias=False)``.
Interpolation runs in f32 and the result is cast back to the input dtype,
as the JAX package's HIGH-precision resize matmuls do.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _interp(x: torch.Tensor, size: Tuple[int, int], mode: str) -> torch.Tensor:
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(
        _nchw(x.to(torch.float32)), size=tuple(size), mode=mode,
        align_corners=False, antialias=False,
    )
    return _nhwc(y).to(x.dtype)


def resize_bilinear(
    x: torch.Tensor, size: Tuple[int, int], flip_w: bool = False
) -> torch.Tensor:
    """NHWC bilinear resize (torch ``align_corners=False``).

    ``flip_w=True`` flips the output horizontally: it equals
    ``torch.flip(resize_bilinear(x, size), dims=(-2,))``."""
    y = _interp(x, size, "bilinear")
    return torch.flip(y, dims=(-2,)) if flip_w else y


def resize_bicubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bicubic resize (torch A=-0.75, ``align_corners=False``)."""
    return _interp(x, size, "bicubic")


@functools.lru_cache(maxsize=512)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """torch 'nearest' (legacy floor) source index per output position."""
    dst = np.arange(out_size, dtype=np.float64)
    return np.minimum(
        np.floor(dst * (in_size / out_size)), in_size - 1
    ).astype(np.int64)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC (or NHW) nearest resize as an index gather, so integer label
    maps keep their values exactly."""
    h_axis = 1
    h, w = x.shape[1], x.shape[2]
    if (h, w) == tuple(size):
        return x
    ih = torch.from_numpy(_nearest_index(h, size[0])).to(x.device)
    iw = torch.from_numpy(_nearest_index(w, size[1])).to(x.device)
    return x.index_select(h_axis, ih).index_select(h_axis + 1, iw)
