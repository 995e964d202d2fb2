"""PyTorch port vs the JAX package: attention.

The port's plain attention (the CPU path of kernels K1/K2) against
cosa_tpu.kernels.attention._xla_attention, output and q/k/v gradients,
with and without key masking. f32; tolerance 1e-5 (softmax sums in
another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cosa_tpu.kernels.attention import _xla_attention
from cosa_tpu_torch.kernels import flash, rff
from cosa_tpu_torch.kernels.attention import attention

TOL = 1e-5


def _qkvg(b, n, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("n,nv", [(37, None), (37, 29), (64, 50), (20, 20)])
def test_plain_attention_and_grads_match_jax(n, nv):
    q, k, v, g = _qkvg(2, n, 3, 16)
    scale = 16 ** -0.5

    def jloss(q, k, v):
        return jnp.sum(_xla_attention(q, k, v, scale, nv) * g)

    jo = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, nv))
    jg = jax.grad(jloss, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    to = flash.plain_attention(tq, tk, tv, scale, nv)
    (to * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), jo, atol=TOL, rtol=0)
    for t, j in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=TOL, rtol=0)


def test_masking_equals_truncation():
    q, k, v, _ = _qkvg(1, 40, 2, 8, seed=1)
    nv = 31
    t = [torch.from_numpy(x) for x in (q, k, v)]
    masked = flash.plain_attention(*t, 0.3, nv)[:, :nv]
    trunc = flash.plain_attention(*(x[:, :nv] for x in t), 0.3)
    np.testing.assert_allclose(masked.numpy(), trunc.numpy(), atol=TOL, rtol=0)


def test_dispatch_on_cpu_tensor_takes_the_plain_version():
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 21, 3 * 4 * 16)).astype(np.float32))
    ref = flash.plain_attention_qkv(qkv, 4, 0.25)
    for use_kernel in (True, False):
        out = attention(qkv, 4, 0.25, use_kernel)
        np.testing.assert_array_equal(out.numpy(), ref.numpy())
    before = dict(flash.LAUNCHES)
    flash.flash_attention_qkv(qkv, 4, 0.25)
    assert flash.LAUNCHES == before  # the plain version counts no launch


def test_kernel_wrappers_refuse_cpu_tensors():
    qkv = torch.zeros((1, 8, 3 * 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash.attn_fwd(qkv, 1, 0.125)
    f = torch.zeros((1, 4, 5))
    w, b = torch.zeros((5, 16)), torch.zeros(16)
    # the RFF wrapper takes its plain version for a CPU tensor
    np.testing.assert_array_equal(rff.rff_phi(f, w, b, 1.0).float().numpy(),
                                  rff.plain_rff_phi(f, w, b, 1.0).float().numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rff_embed_goes_through_the_kernel_wrapper(monkeypatch, dtype):
    """Both stored precisions reach K3's wrapper (which, on a CPU tensor,
    takes the plain version): no dtype is routed around the kernel."""
    from cosa_tpu_torch.ops import bilateral

    calls = []

    def spy(f, w, b, scale, out_dtype):
        calls.append(out_dtype)
        return rff.rff_phi(f, w, b, scale, out_dtype)

    monkeypatch.setattr(bilateral, "rff_phi", spy)
    f = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 9, 5)).astype(np.float32))
    phi = bilateral.rff_embed(f, 32, 0, dtype)
    assert calls == [dtype] and phi.dtype == dtype and phi.shape == (2, 9, 32)
    w, b = (torch.from_numpy(a) for a in bilateral._rff_params(32, 5, 0))
    ref = rff.plain_rff_phi(f, w, b, float(np.sqrt(2.0 / 32)), dtype)
    np.testing.assert_array_equal(phi.float().numpy(), ref.float().numpy())
