"""PyTorch port vs the JAX package: the softmax-variant attention forward
(K4, scripts/microbench_softmax.py::attend_variant).

The JAX function runs its Pallas kernel in interpret mode on the CPU, on
inputs already padded to a multiple of 128 (it does not pad itself), with
keys at or past ``n_valid`` masked. Bound: max |plain - JAX| <= 8e-3, one
bf16 quantum at |o| in [1, 2): the JAX output is stored in bf16, the plain
version returns f32."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosa_tpu_torch.kernels import flash_variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BH, N, D = 4, 256, 64
SCALE = 1 / 8.0


def _microbench(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "microbench_softmax", os.path.join(ROOT, "scripts", "microbench_softmax.py"))
    mb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mb)
    monkeypatch.setattr(mb.pl, "pallas_call",
                        functools.partial(mb.pl.pallas_call, interpret=True))
    return mb


@pytest.mark.parametrize("n_valid", [150, N])
@pytest.mark.parametrize("mode", flash_variants.MODES)
def test_plain_variant_matches_jax_interpret(monkeypatch, mode, n_valid):
    mb = _microbench(monkeypatch)
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((BH, N, D)).astype(np.float32) for _ in range(3))
    ref = mb.attend_variant(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                            SCALE, n_valid, mode)
    ref = np.asarray(ref.astype(jnp.float32))
    ours = flash_variants.plain_attend_variant(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), SCALE, n_valid, mode)
    assert ours.dtype == torch.float32
    assert np.isfinite(ref).all()
    assert np.abs(ours.numpy() - ref).max() <= 8e-3


def test_variant_wrapper_raises_off_the_card():
    qkv = torch.zeros((1, 70, 3 * 2 * 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_variants.attn_fwd_variant(qkv, 2, SCALE, None, "bf16exp")
    with pytest.raises(ValueError, match="mode"):
        flash_variants.attn_fwd_variant(qkv, 2, SCALE, None, "fp8exp")
    assert all(n == 0 for n in flash_variants.LAUNCHES.values())
