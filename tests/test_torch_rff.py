"""PyTorch port vs the JAX package: the random-Fourier-feature embedding
(K3, cosa_tpu/kernels/rff.py::rff_phi).

The port's kernel evaluates the TPU kernel's polynomial cosine from the
port's own copy of its coefficients; its plain version (what a CPU tensor
takes) uses torch.cos. Here both are held to the JAX package: the
coefficients exactly, the polynomial in torch within 1e-6 of the JAX one,
and the port's rff_phi on the CPU against the Pallas kernel itself, run in
interpret mode. That last bound is 5e-6 for an f32 store: the polynomial's
error (at most 1.1e-5 at |phase| <= 150, times the scale 0.088) plus the
phase's own rounding (torch's product sums the five terms in another order
than the Pallas kernel's FMAs); one bf16 quantum at the output's magnitude
for a bf16 store."""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosa_tpu.kernels import rff as jax_rff
from cosa_tpu_torch.kernels import rff


def test_cos_coefficients_equal_the_jax_fit():
    assert rff.COS_POLY == tuple(jax_rff._COS_POLY)


def test_plain_cos_poly_matches_jax():
    p = np.random.default_rng(3).uniform(-256.0, 256.0, 100_000).astype(np.float32)
    ours = rff.plain_cos_poly(torch.from_numpy(p)).numpy()
    ref = np.asarray(jax_rff._cos_poly(jnp.asarray(p)))
    assert ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1e-6


def _inputs(rng, bsz, n, d):
    """Pixel-like features and weights whose phases reach about 150."""
    f = np.concatenate([rng.uniform(0.0, 4.5, (bsz, n, 2)),
                        rng.uniform(0.0, 17.0, (bsz, n, 3))], axis=-1).astype(np.float32)
    w = (rng.standard_normal((5, d)) * 1.8).astype(np.float32)
    b = rng.uniform(0.0, 2.0 * np.pi, d).astype(np.float32)
    return f, w, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rff_phi_matches_the_pallas_kernel(monkeypatch, dtype):
    monkeypatch.setattr(jax_rff.pl, "pallas_call",
                        functools.partial(jax_rff.pl.pallas_call, interpret=True))
    bsz, n, d = 2, 1000, 256  # 1000 rows: the Pallas kernel pads to its 512-row tile
    f, w, b = _inputs(np.random.default_rng(4), bsz, n, d)
    phase = np.abs(f.astype(np.float64) @ w + b).max()
    assert 100.0 < phase < 200.0
    scale = math.sqrt(2.0 / d)
    ref = jax_rff.rff_phi(jnp.asarray(f), jnp.asarray(w), jnp.asarray(b), scale,
                          getattr(jnp, dtype))
    ref = np.asarray(ref.astype(jnp.float32))
    ours = rff.rff_phi(torch.from_numpy(f), torch.from_numpy(w), torch.from_numpy(b),
                       scale, getattr(torch, dtype))
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (bsz, n, d)
    # one bf16 quantum for |phi| <= scale (in [2^-4, 2^-3) here)
    tol = 5e-6 if dtype == "float32" else 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert np.abs(ours.float().numpy() - ref).max() <= tol
