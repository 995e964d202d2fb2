"""Random-Fourier-feature embedding: kernel K3 and its plain version.

``phi = scale * cos(features @ W + b)`` over every pixel row, stored bf16
or f32. The kernel (``csrc/rff_phi.cu``) replaces the JAX package's Pallas
``_phi_kernel`` (kernels/rff.py); it never writes the f32 projection.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"rff_phi": 0}

_VP = ctypes.c_void_p
_TYPED = []
FEATURE_DIM = 5  # pixel features (x, y, r, g, b): the only width the kernel takes
OUT_DTYPES = (torch.bfloat16, torch.float32)


def _lib():
    from cosa_tpu_torch.kernels.build import load

    lib = load("rff")
    if lib not in _TYPED:
        lib.cosa_rff_phi.argtypes = [_VP] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, _VP]
        lib.cosa_rff_phi.restype = ctypes.c_int
        _TYPED.append(lib)
    return lib


def plain_rff_phi(features: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  scale: float, dtype=torch.bfloat16) -> torch.Tensor:
    """(..., dim) f32 -> (..., D) ``dtype``: f32 projection, f32 cos."""
    proj = features.to(torch.float32) @ w + b
    return (scale * torch.cos(proj)).to(dtype)


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
    err = _lib().cosa_rff_phi(
        features.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        bsz * n, n_feat, float(scale), int(dtype == torch.float32),
        torch.cuda.current_stream(features.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cosa_rff_phi failed: cudaError_t {err}")
    LAUNCHES["rff_phi"] += 1
    return out
