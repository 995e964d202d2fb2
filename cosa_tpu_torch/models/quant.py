"""int8 dense layers for the no-grad teacher's TTA (the JAX package's
models/quant.py).

Standard dynamic quantization, applied to the teacher's projections when
``teacher_int8`` is on (train/step.py), never to the student:

  * weights: symmetric per output channel, quantized from the f32
    parameter at each call, so the EMA teacher keeps no second copy;
  * activations: symmetric per row (per token);
  * the int32 product, then ``acc * row_scale * col_scale + bias`` in f32
    and one cast to the output dtype.

The int8 product is no TPU kernel: the JAX package leaves it to XLA
(``jax.lax.dot(..., preferred_element_type=int32)``). On a CUDA tensor it
is one ``torch._int_mm`` call (cuBLASLt) or it raises; there is no f32
product in its place. On a CPU tensor it is :func:`plain_int_mm`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from cosa_tpu_torch.kernels import counter
from cosa_tpu_torch.parallel.tensor import all_reduce_max

# torch._int_mm calls made for a CUDA tensor, counted where they are made
LAUNCHES = counter("int8_mm")
_INV127 = float(np.float32(1.0) / np.float32(127.0))


def _quantize(x: torch.Tensor, dim: int, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The max over ``dim`` times f32(1/127), the product XLA compiles the
    JAX package's ``/ 127`` into: one IEEE product on the CPU and the card
    alike (torch's CUDA division by a Python scalar is a product with its
    reciprocal, its CPU division a true division). With ``group`` (a
    tensor-parallel group that splits ``dim``) the max runs over every
    rank's share, so the codes equal the unsplit tensor's."""
    xf = x.to(torch.float32)
    s = all_reduce_max(xf.abs().amax(dim=dim, keepdim=True), group) * _INV127
    s = torch.clamp(s, min=1e-12)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_rows(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) float -> int8 rows and (..., 1) f32 scales (symmetric)."""
    return _quantize(x, -1, group)


def quantize_cols(w: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """An ``nn.Linear`` weight (N, K) -> int8 (N, K) and (1, N) f32 scales,
    one per output channel (the max runs over K, the JAX kernel's axis 0)."""
    q, s = _quantize(w, 1, group)
    return q, s.reshape(1, -1)


def plain_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exactly: the float64
    product of int8 codes is exact, every partial sum being an integer of
    magnitude at most K * 127^2 < 2^53."""
    k = a.shape[1]
    if k * 127 * 127 >= 2 ** 31:
        raise ValueError(f"int8 product with K = {k} overflows int32")
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int32 product of int8 (M, K) and (K, N): ``torch._int_mm`` on a
    CUDA tensor, :func:`plain_int_mm` on a CPU tensor. cuBLASLt takes more
    than 16 rows and K and N multiples of 8; a CUDA call outside those
    raises with its shape."""
    if not a.is_cuda:
        return plain_int_mm(a, b)
    (m, k), n = a.shape, b.shape[1]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(
            f"int8 product ({m}, {k}) x ({k}, {n}): torch._int_mm takes more "
            "than 16 rows and K and N multiples of 8")
    LAUNCHES["int8_mm"] += 1
    return torch._int_mm(a, b)


def int8_product(x: torch.Tensor, weight: torch.Tensor, group=None) -> torch.Tensor:
    """(M, K) float times an ``nn.Linear`` weight (N, K) by the dynamic
    int8 product: ``acc * xs * ws`` in f32, (M, N). With ``group``, K is
    split over its ranks (a row-parallel layer): the scales' maxima run
    over the whole K and the result is this rank's partial sum."""
    xq, xs = quantize_rows(x, group)
    wq, ws = quantize_cols(weight, group)
    return int_mm(xq, wq.t()).to(torch.float32) * xs * ws


def int8_matmul(x: torch.Tensor, layer: nn.Linear, out_dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied to ``x`` (..., K) by the dynamic int8 product: the
    weight quantized from its f32 parameter, then ``acc * xs * ws``, the
    bias added in f32, one cast to ``out_dtype``."""
    lead, k = x.shape[:-1], x.shape[-1]
    out = int8_product(x.reshape(-1, k), layer.weight)
    if layer.bias is not None:
        out = out + layer.bias.to(torch.float32)
    return out.reshape(*lead, -1).to(out_dtype)
