"""Random-Fourier-feature embedding: kernel K3 and its plain version.

``phi = scale * cos(features @ W + b)`` over every pixel row, stored bf16
or f32. The kernel (``csrc/rff_phi.cu``) replaces the JAX package's Pallas
``_phi_kernel`` (kernels/rff.py); it never writes the f32 projection.

The kernel evaluates the cosine as the TPU kernel does: a range reduction
and a degree-5 polynomial in r^2, whose coefficients :data:`COS_POLY` are
the same numpy fit. The plain version takes ``torch.cos``, as the JAX
package's XLA path does. The two differ by the polynomial's error times
``scale``: 1.9e-6 at |phase| <= pi, growing with the f32 range reduction
to 1.1e-5 at |phase| <= 150 and 1.4e-5 at |phase| <= 256.
:func:`plain_cos_poly` is the polynomial in torch, for tests.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from cosa_tpu_torch.kernels import counter

LAUNCHES = counter("rff_phi")

_VP = ctypes.c_void_p
_TYPED = []
FEATURE_DIM = 5  # pixel features (x, y, r, g, b): the only width the kernel takes
OUT_DTYPES = (torch.bfloat16, torch.float32)

# cos(sqrt(u)) on [0, pi^2] as a degree-5 polynomial in u, highest degree
# first: the least-squares fit on 20001 points of the TPU kernel
_U = np.linspace(0.0, np.pi ** 2, 20001)
COS_POLY = tuple(float(c) for c in np.polyfit(_U, np.cos(np.sqrt(_U)), 5))
_INV2PI = 1.0 / (2.0 * math.pi)
_TWOPI = 2.0 * math.pi


def _lib():
    from cosa_tpu_torch.kernels.build import load

    lib = load("rff")
    if lib not in _TYPED:
        lib.cosa_rff_phi.argtypes = [_VP] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, _VP]
        lib.cosa_rff_phi.restype = ctypes.c_int
        _TYPED.append(lib)
    return lib


def plain_rff_phi(features: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  scale: float, dtype=torch.bfloat16) -> torch.Tensor:
    """(..., dim) f32 -> (..., D) ``dtype``: f32 projection, f32 cos."""
    proj = features.to(torch.float32) @ w + b
    return (scale * torch.cos(proj)).to(dtype)


def plain_cos_poly(p: torch.Tensor) -> torch.Tensor:
    """cos of f32 phases ``p`` as the kernel (and the TPU kernel) evaluates
    it: r = p - 2 pi round(p / 2 pi), then Horner in u = r^2."""
    r = p - _TWOPI * torch.round(p * _INV2PI)
    u = r * r
    y = torch.full_like(u, COS_POLY[0])
    for c in COS_POLY[1:]:
        y = y * u + c
    return y


def rff_phi(features: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            scale: float, dtype=torch.bfloat16) -> torch.Tensor:
    """K3. features (B, N, 5) f32, w (5, D) f32, b (D,) f32 on the card ->
    (B, N, D) ``dtype`` (bf16 or f32). A CPU tensor takes the plain version."""
    if features.device.type == "cpu":
        return plain_rff_phi(features, w, b, scale, dtype)
    if dtype not in OUT_DTYPES:
        raise ValueError(f"rff_phi: output dtype must be one of {OUT_DTYPES}, got {dtype}")
    n_feat = w.shape[1]
    for name, x in (("features", features), ("w", w), ("b", b)):
        if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"rff_phi: {name} must be a contiguous f32 CUDA tensor")
    if features.dim() != 3 or features.shape[-1] != FEATURE_DIM \
            or tuple(w.shape) != (FEATURE_DIM, n_feat) or tuple(b.shape) != (n_feat,):
        raise ValueError(
            f"rff_phi: features (B, N, {FEATURE_DIM}), w ({FEATURE_DIM}, D), b (D,); "
            f"got {tuple(features.shape)}, {tuple(w.shape)}, {tuple(b.shape)}"
        )
    if n_feat % 8 or 256 % (n_feat // 8):
        raise ValueError(f"rff_phi: D = {n_feat} must be 8 * a divisor of 256")
    bsz, n, _ = features.shape
    out = torch.empty((bsz, n, n_feat), dtype=dtype, device=features.device)
    poly = (ctypes.c_float * 6)(*(scale * c for c in COS_POLY))  # scale folded in
    with torch.cuda.device(features.device):
        err = _lib().cosa_rff_phi(
            features.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            bsz * n, n_feat, poly, int(dtype == torch.float32),
            torch.cuda.current_stream(features.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"cosa_rff_phi failed: cudaError_t {err}")
    LAUNCHES["rff_phi"] += 1
    return out
