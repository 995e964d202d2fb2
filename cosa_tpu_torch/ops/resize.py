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


def _interp(x: torch.Tensor, size: Tuple[int, int], mode: str,
            align_corners: bool = False) -> torch.Tensor:
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(
        _nchw(x.to(torch.float32)), size=tuple(size), mode=mode,
        align_corners=align_corners, antialias=False,
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


def resize_bilinear_ac(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize with ``align_corners=True`` (PAR's mask resize,
    reference models/PAR.py:66)."""
    return _interp(x, size, "bilinear", align_corners=True)


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


def resize(x: torch.Tensor, size: Tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """NHWC resize by ``method``: "bilinear", "bicubic" or "nearest"."""
    if method == "bilinear":
        return resize_bilinear(x, size)
    if method == "bicubic":
        return resize_bicubic(x, size)
    if method == "nearest":
        return resize_nearest(x, size)
    raise ValueError(method)


@functools.lru_cache(maxsize=512)
def _linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) interpolation matrix of torch bilinear, align_corners=False
    (the JAX package's ops/resize.py::_linear_matrix)."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = np.maximum((dst + 0.5) * scale - 0.5, 0.0)
    i0 = np.floor(src).astype(np.int64)
    lam = src - i0
    i0 = np.clip(i0, 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(m, (dst.astype(np.int64), i0), 1.0 - lam)
    np.add.at(m, (dst.astype(np.int64), i1), lam)
    return m.astype(np.float32)


def np_resize_bilinear(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """HWC / HW numpy bilinear resize (torch ``align_corners=False``), for
    host-side maps at an image's own size."""
    h, w = x.shape[:2]
    mh, mw = _linear_matrix(h, size[0]), _linear_matrix(w, size[1])
    y = np.tensordot(mh, x.astype(np.float32), axes=[[1], [0]])
    y = np.tensordot(mw, y, axes=[[1], [1]])
    return np.moveaxis(y, 0, 1)
