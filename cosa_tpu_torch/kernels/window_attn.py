"""Swin's window attention: kernel K6 (forward and backward) and its plain
version.

For each window and head of the qkv dense's (B*nW, n, 3, h, hd) output:
the scores of the scaled q against k, the learned relative-position bias
read from its ((2w-1)^2, h) table through :func:`rel_pos_index`, an optional
additive (nW, n, n) mask (window i takes mask i mod nW), the softmax and the
product with v, returned as (B*nW, n, h*hd) for the output dense. The plain
version is the chain ``models/zoo/swin.py::WindowAttention`` ran inline,
as the JAX package leaves it to XLA: the scores round to the compute dtype
before the f32 bias and mask, the softmax runs in f32, and p rounds to the
compute dtype before the product with v.

The kernels (``csrc/window_attn.cu``) replace no Pallas kernel. They read
q, k and v in place, fold the scale in, and round where the plain version
rounds; the backward recomputes p from the forward's row max and sum,
writes the gradient in the qkv layout and sums the table's gradient in a
fixed order. A wrapper launches its kernel for a CUDA tensor, or raises; it
takes the plain version only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from cosa_tpu_torch.kernels import counter

MAX_WINDOW = 8  # a window of at most 64 tokens: one tile of the kernels
MAX_HEAD_DIM = 32  # the widest head of SWIN_CONFIGS; the kernels build 16 and 32
DTYPES = (torch.bfloat16, torch.float32)

# launches of each kernel's wrapper on the card; plain integers
LAUNCHES = counter("window_attn_fwd", "window_attn_bwd")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_TYPED = []  # libraries whose C signatures are set


def _lib():
    from cosa_tpu_torch.kernels.build import load

    lib = load("window_attn")
    if lib not in _TYPED:
        lib.cosa_window_attn_fwd.argtypes = [_VP] * 5 + [_I] * 5 + [ctypes.c_float, _I, _VP]
        lib.cosa_window_attn_fwd.restype = _I
        lib.cosa_window_attn_bwd.argtypes = [_VP] * 8 + [_I] * 5 + [ctypes.c_float, _I, _VP]
        lib.cosa_window_attn_bwd.restype = _I
        _TYPED.append(lib)
    return lib


def rel_pos_index(w: int) -> np.ndarray:
    """(w^2, w^2) index into the (2w-1)^2 relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, w^2, w^2)
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _index(w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rel_pos_index(w)).to(device)


def plain_window_attention(qkv: torch.Tensor, table: torch.Tensor, window: int,
                           mask: Optional[torch.Tensor] = None,
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """qkv (B*nW, n, 3, h, hd) in the compute dtype, table ((2w-1)^2, h)
    f32, mask (nW, n, n) f32 or None -> (B*nW, n, h*hd): library ops.
    ``dtype`` is the type of the scores and the softmax: with float64 and
    ``qkv.double()`` nothing rounds, the reference that K6 and the plain
    version are held to (tests, chip_smoke.py)."""
    bn, n, _, h, hd = qkv.shape
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    # the scores round to the compute dtype before the f32 bias and mask
    s = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k).to(dtype)
    s = s + table.to(dtype)[_index(window, qkv.device)].permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        s = s.reshape(bn // nw, nw, h, n, n) + mask.to(dtype)[None, :, None]
        s = s.reshape(bn, h, n, n)
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(bn, n, h * hd)


def check_dims(window: int, head_dim: int) -> None:
    """Raise unless the kernels take this window side and head width: a
    window of at most 8 x 8 tokens, a head 8 to 32 wide in steps of 8."""
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"window attention kernel: window {window} outside 1..{MAX_WINDOW}")
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"window attention kernel: head width {head_dim} is not a "
                         f"multiple of 8 in 8..{MAX_HEAD_DIM}")


def _check(qkv: torch.Tensor, table: torch.Tensor, window: int,
           mask: Optional[torch.Tensor]) -> int:
    """Raise on what the kernels do not take; returns the number of masks."""
    if not qkv.is_cuda or qkv.dtype not in DTYPES or qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"window attention kernel: qkv must be a CUDA (B*nW, n, 3, h, hd) "
                         f"tensor of {DTYPES}; got {qkv.dtype} {tuple(qkv.shape)} on "
                         f"{qkv.device}")
    bn, n, _, h, hd = qkv.shape
    check_dims(window, hd)
    if n != window * window:
        raise ValueError(f"window attention kernel: {n} tokens a window, not {window}^2")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("window attention kernel: qkv must be contiguous and 16-byte aligned")
    if table.device != qkv.device or table.dtype != torch.float32 \
            or tuple(table.shape) != ((2 * window - 1) ** 2, h):
        raise ValueError(f"window attention kernel: table must be f32 "
                         f"({(2 * window - 1) ** 2}, {h}) on {qkv.device}; got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")
    if mask is None:
        return 1
    if mask.device != qkv.device or mask.dtype != torch.float32 or mask.dim() != 3 \
            or tuple(mask.shape[1:]) != (n, n) or bn % mask.shape[0] \
            or not mask.is_contiguous():
        raise ValueError(f"window attention kernel: mask must be a contiguous f32 (nW, {n}, "
                         f"{n}) tensor on {qkv.device} with nW dividing {bn}; got "
                         f"{mask.dtype} {tuple(mask.shape)} on {mask.device}")
    return mask.shape[0]


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def window_attn_fwd(qkv: torch.Tensor, table: torch.Tensor, window: int,
                    mask: Optional[torch.Tensor] = None, save: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K6's forward -> (o (B*nW, n, h*hd) in qkv's dtype, with ``save`` the
    rows' softmax max and sum (B*nW, h, n, 2) f32, else None)."""
    table = table.contiguous()
    nw = _check(qkv, table, window, mask)
    bn, n, _, h, hd = qkv.shape
    out = torch.empty((bn, n, h * hd), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((bn, h, n, 2), dtype=torch.float32, device=qkv.device) if save else None
    with torch.cuda.device(qkv.device):
        err = _lib().cosa_window_attn_fwd(
            qkv.data_ptr(), table.data_ptr(), _ptr(mask), out.data_ptr(), _ptr(stats), bn,
            window, h, hd, nw, hd ** -0.5, int(qkv.dtype == torch.float32),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if err:
        raise RuntimeError(f"cosa_window_attn_fwd failed: cudaError_t {err}")
    LAUNCHES["window_attn_fwd"] += 1
    return out, stats


def window_attn_bwd(qkv: torch.Tensor, table: torch.Tensor, window: int,
                    mask: Optional[torch.Tensor], stats: torch.Tensor,
                    dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's backward -> (dqkv in qkv's layout and dtype, dtable f32), from
    the forward's inputs, its saved ``stats`` and the output's cotangent.
    Deterministic: the table's gradient is summed in a fixed order."""
    table = table.contiguous()
    nw = _check(qkv, table, window, mask)
    bn, n, _, h, hd = qkv.shape
    if dout.dtype != qkv.dtype or tuple(dout.shape) != (bn, n, h * hd) \
            or not dout.is_contiguous() or dout.data_ptr() % 16:
        raise ValueError(f"window attention kernel: dout must be a contiguous {qkv.dtype} "
                         f"({bn}, {n}, {h * hd}) tensor; got {dout.dtype} {tuple(dout.shape)}")
    if stats.dtype != torch.float32 or tuple(stats.shape) != (bn, h, n, 2) \
            or not stats.is_contiguous():
        raise ValueError("window attention kernel: stats must be contiguous f32 (B*nW, h, n, 2)")
    t = (2 * window - 1) ** 2
    dqkv = torch.empty_like(qkv)
    part = torch.empty((bn, h, t), dtype=torch.float32, device=qkv.device)
    dtable = torch.empty((t, h), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _lib().cosa_window_attn_bwd(
            qkv.data_ptr(), table.data_ptr(), _ptr(mask), stats.data_ptr(), dout.data_ptr(),
            dqkv.data_ptr(), part.data_ptr(), dtable.data_ptr(), bn, window, h, hd, nw,
            hd ** -0.5, int(qkv.dtype == torch.float32),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if err:
        raise RuntimeError(f"cosa_window_attn_bwd failed: cudaError_t {err}")
    LAUNCHES["window_attn_bwd"] += 1
    return dqkv, dtable


class WindowAttentionFn(torch.autograd.Function):
    """K6: the forward kernel, and the backward kernel for its gradient."""

    @staticmethod
    def forward(ctx, qkv, table, mask, window):
        out, stats = window_attn_fwd(qkv, table, window, mask, save=True)
        ctx.save_for_backward(qkv, table, mask, stats)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, table, mask, stats = ctx.saved_tensors
        dqkv, dtable = window_attn_bwd(qkv, table, ctx.window, mask, stats, dout.contiguous())
        return dqkv, dtable, None, None


def window_attention(qkv: torch.Tensor, table: torch.Tensor, window: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """qkv (B*nW, n, 3, h, hd), table ((2w-1)^2, h) f32, mask (nW, n, n) f32
    or None -> (B*nW, n, h*hd). K6 on a CUDA tensor (its backward with it
    where a gradient is wanted); the plain version on a CPU tensor."""
    if qkv.device.type == "cpu":
        return plain_window_attention(qkv, table, window, mask)
    if torch.is_grad_enabled() and (qkv.requires_grad or table.requires_grad):
        return WindowAttentionFn.apply(qkv, table, mask, window)
    return window_attn_fwd(qkv, table, window, mask)[0]
