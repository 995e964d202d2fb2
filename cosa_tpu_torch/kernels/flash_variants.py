"""Attention forward with the softmax variants of the JAX package's softmax
microbenchmark: kernel K4 and its plain PyTorch version.

The kernel lives in ``csrc/flash_variants.cu`` and replaces the Pallas
``attend_variant`` (``_fwd_variant``) of scripts/microbench_softmax.py. It
is K1's forward with one of two softmax variants:

  * ``bf16exp``: exp2 evaluated on bf16 (s - m), the row sum in f32;
  * ``nomax``: exp2(s - 30) in f32, a fixed shift in place of the row max.

Only the microbenchmark entry point (``cli/microbench_softmax.py``) calls
it, on the card: :func:`attn_fwd_variant` launches the kernel for a CUDA
tensor and raises for any other. :func:`plain_attend_variant` is for tests
and for the on-card checks.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cosa_tpu_torch.kernels.flash import HEAD_DIM, _check, _dims

MODES = ("bf16exp", "nomax")
LOG2E = 1.4426950408889634
NOMAX_SHIFT = 30.0  # microbench_softmax.py:56

# launches of the kernel's wrapper on the card, by mode; plain integers
LAUNCHES = {f"flash_fwd_{m}": 0 for m in MODES}

_VP = ctypes.c_void_p
_TYPED = []  # libraries whose C signature is set


def _lib():
    from cosa_tpu_torch.kernels.build import load

    lib = load("flash_variants")
    if lib not in _TYPED:
        lib.cosa_attn_fwd_variant.argtypes = [_VP, _VP] + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, _VP]
        lib.cosa_attn_fwd_variant.restype = ctypes.c_int
        _TYPED.append(lib)
    return lib


def _mode_index(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    return MODES.index(mode)


def plain_attend_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, n_valid: Optional[int], mode: str) -> torch.Tensor:
    """q, k, v: (BH, N, D) in the JAX function's layout -> (BH, N, D) f32.

    ``_fwd_variant`` step by step: q * scale * log2(e) rounded to q's dtype,
    f32 scores, keys at or past ``n_valid`` at -1e30, then the variant's
    softmax, p in q's dtype into an f32 PV product, division by l. The
    result is returned before the final store's rounding, so a comparison
    with the kernel sees the kernel's own rounding only."""
    _mode_index(mode)
    dt = q.dtype
    qs = (q.to(torch.float32) * (scale * LOG2E)).to(dt)
    s = torch.einsum("bqd,bkd->bqk", qs.to(torch.float32), k.to(torch.float32))
    n = k.shape[1]
    if n_valid is not None and n_valid < n:
        key_ok = torch.arange(n, device=q.device) < n_valid
        s = torch.where(key_ok[None, None, :], s, torch.full_like(s, -1e30))
    if mode == "bf16exp":
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2((s - m).to(torch.bfloat16))
        l = p.to(torch.float32).sum(dim=-1, keepdim=True)
    else:
        p = torch.exp2(s - NOMAX_SHIFT)
        l = p.sum(dim=-1, keepdim=True)
    p = p.to(dt).to(torch.float32)
    o = torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32))
    return o / l


def attn_fwd_variant(qkv: torch.Tensor, num_heads: int, scale: float,
                     n_valid: Optional[int], mode: str) -> torch.Tensor:
    """K4. qkv (B, N, 3*H*64) bf16 on the card -> o (B, N, H*64) bf16."""
    mi = _mode_index(mode)
    b, n, nv = _dims(qkv, num_heads, n_valid)
    _check("qkv", qkv, qkv.shape)
    out = torch.empty((b, n, num_heads * HEAD_DIM), dtype=qkv.dtype, device=qkv.device)
    err = _lib().cosa_attn_fwd_variant(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, nv, float(scale), mi,
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cosa_attn_fwd_variant failed: cudaError_t {err}")
    LAUNCHES[f"flash_fwd_{mode}"] += 1
    return out
