"""Fused attention for the ViT encoder: kernels K1 (forward) and K2
(backward) and their plain PyTorch version.

The kernels live in ``csrc/flash_attn.cu`` (they replace the JAX package's
Pallas ``_fwd_kernel`` / ``_bwd_kernel``, kernels/flash.py). They read the
packed (B, N, 3, H, 64) bf16 qkv projection in place and write the
gradient into the same layout, so no fold copies surround them.

A wrapper launches its kernel for a CUDA tensor, or raises; it takes the
plain version only for a tensor on the CPU.

K1 works on blocks of 64 or 128 queries, which :func:`block_rows` picks
from N; K2 on blocks of 128 keys.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cosa_tpu_torch.kernels import counter

HEAD_DIM = 64  # the only head width the kernels take
# K1 runs 128-query blocks above this many tokens, 64-query blocks up to it
BLOCK_128_ABOVE = 1024

# launches of each kernel's wrapper on the card (K1, K2); plain integers
LAUNCHES = counter("flash_fwd", "flash_bwd")

_VP = ctypes.c_void_p
_TYPED = []  # libraries whose C signatures are set


def _lib():
    from cosa_tpu_torch.kernels.build import load

    lib = load("flash")
    if lib not in _TYPED:
        lib.cosa_attn_fwd.argtypes = [_VP, _VP, _VP] + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, _VP]
        lib.cosa_attn_fwd.restype = ctypes.c_int
        lib.cosa_attn_bwd.argtypes = [_VP] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, _VP]
        lib.cosa_attn_bwd.restype = ctypes.c_int
        _TYPED.append(lib)
    return lib


def plain_attention(q, k, v, scale: float, n_valid: Optional[int] = None):
    """q, k, v: (B, N, H, D) -> (B, N, H, D). The einsum + f32-softmax path
    of the JAX package's ``_xla_attention``; keys at or beyond ``n_valid``
    are masked out."""
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    n = q.shape[1]
    if n_valid is not None and n_valid < n:
        key_ok = torch.arange(n, device=q.device) < n_valid
        s = torch.where(key_ok[None, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def plain_attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                        n_valid: Optional[int] = None) -> torch.Tensor:
    """:func:`plain_attention` on the packed (B, N, 3*C) projection."""
    b, n, c3 = qkv.shape
    x = qkv.reshape(b, n, 3, num_heads, c3 // (3 * num_heads))
    o = plain_attention(x[:, :, 0], x[:, :, 1], x[:, :, 2], scale, n_valid)
    return o.reshape(b, n, c3 // 3)


def f64_attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                      n_valid: Optional[int] = None) -> torch.Tensor:
    """:func:`plain_attention_qkv` in float64 throughout, returned in
    float64 and differentiable: the reference that K1/K2 and the plain
    path are held to (chip_smoke.py, cli/audit_attention.py). One batch
    row at a time, so that one row's (H, N, N) scores are the largest
    temporary."""
    b, n, c3 = qkv.shape
    x = qkv.double().reshape(b, n, 3, num_heads, c3 // (3 * num_heads))
    rows = []
    for i in range(b):
        xi = x[i:i + 1]
        s = torch.einsum("bqhd,bkhd->bhqk", xi[:, :, 0] * scale, xi[:, :, 1])
        if n_valid is not None and n_valid < n:
            s = s.masked_fill(torch.arange(n, device=s.device) >= n_valid, float("-inf"))
        rows.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), xi[:, :, 2]))
    return torch.cat(rows).reshape(b, n, c3 // 3)


def block_rows(n: int) -> int:
    """Queries per block of K1 at N tokens: 64 (one warpgroup) up to
    BLOCK_128_ABOVE, 128 (two) above. chip_smoke.py times both at each
    (B*H, N) the paths launch; on an H100 SXM 64 read faster at N = 197
    and 785 and within 1% at 442, 128 faster at 1226 and 1765, at every
    B*H of 48 to 192."""
    return 128 if n > BLOCK_128_ABOVE else 64


def _check(name: str, x: torch.Tensor, shape) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel needs a CUDA tensor")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a contiguous, 16-byte aligned tensor")


def _dims(qkv: torch.Tensor, num_heads: int, n_valid: Optional[int]):
    b, n, c3 = qkv.shape
    if c3 != 3 * num_heads * HEAD_DIM:
        raise ValueError(
            f"attention kernels take head dim {HEAD_DIM}: qkv width {c3}, "
            f"{num_heads} heads"
        )
    nv = n if n_valid is None else int(n_valid)
    if not 1 <= nv <= n:
        raise ValueError(f"n_valid {nv} outside [1, {n}]")
    return b, n, nv


def attn_fwd(qkv: torch.Tensor, num_heads: int, scale: float,
             n_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1. qkv (B, N, 3*H*64) bf16 on the card -> (o (B, N, H*64) bf16,
    lse (B, H, N) f32, the base-2 log-sum-exp of each query row)."""
    b, n, nv = _dims(qkv, num_heads, n_valid)
    _check("qkv", qkv, qkv.shape)
    out = torch.empty((b, n, num_heads * HEAD_DIM), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    err = _lib().cosa_attn_fwd(
        qkv.data_ptr(), out.data_ptr(), lse.data_ptr(), b, n, num_heads, nv,
        float(scale), block_rows(n),
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cosa_attn_fwd failed: cudaError_t {err}")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def attn_bwd(qkv: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
             num_heads: int, scale: float,
             n_valid: Optional[int] = None) -> torch.Tensor:
    """K2. Gradient of :func:`attn_fwd` with respect to qkv, in qkv's
    layout (B, N, 3*H*64) bf16, from qkv, the output's cotangent and K1's
    log-sum-exp (delta = rowsum(P * dP) is recomputed from f32 P, not read
    off the bf16 output). Deterministic: dq's partial sums are added as
    64-bit fixed point, in any order to the same result."""
    b, n, nv = _dims(qkv, num_heads, n_valid)
    _check("qkv", qkv, qkv.shape)
    _check("dout", dout, (b, n, num_heads * HEAD_DIM))
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, num_heads, n) \
            or not lse.is_contiguous():
        raise ValueError("lse: expected contiguous f32 (B, H, N)")
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)
    # dq's sum, 64-bit fixed point (csrc/flash_attn.cu: deterministic)
    dq_acc = torch.empty((b, n, num_heads, HEAD_DIM), dtype=torch.int64,
                         device=qkv.device)
    err = _lib().cosa_attn_bwd(
        qkv.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq_acc.data_ptr(), dqkv.data_ptr(), b, n, num_heads,
        nv, float(scale),
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"cosa_attn_bwd failed: cudaError_t {err}")
    LAUNCHES["flash_bwd"] += 1
    return dqkv


class FlashAttention(torch.autograd.Function):
    """K1 forward, K2 backward, on the packed qkv projection."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, n_valid):
        out, lse = attn_fwd(qkv, num_heads, scale, n_valid)
        ctx.save_for_backward(qkv, lse)
        ctx.cfg = (num_heads, scale, n_valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, lse = ctx.saved_tensors
        num_heads, scale, n_valid = ctx.cfg
        dqkv = attn_bwd(qkv, dout.contiguous(), lse, num_heads, scale, n_valid)
        return dqkv, None, None, None


def flash_attention_qkv(qkv: torch.Tensor, num_heads: int, scale: float,
                        n_valid: Optional[int] = None) -> torch.Tensor:
    """qkv (B, N, 3*C) -> attention output (B, N, C). The kernels on a CUDA
    tensor; the plain version on a CPU tensor."""
    if qkv.device.type == "cpu":
        return plain_attention_qkv(qkv, num_heads, scale, n_valid)
    return FlashAttention.apply(qkv, num_heads, scale, n_valid)
