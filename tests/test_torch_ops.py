"""PyTorch port vs the JAX package: image ops and resizes (NHWC, f32).

The same numpy inputs go through cosa_tpu.ops and cosa_tpu_torch.ops;
tolerance 1e-5 of the input's range: the port interpolates in f32, while
the JAX package's resize matmuls run at Precision.HIGH (bf16x3), whose
error scales with the magnitude of the inputs summed (about 3e-6 of it)."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# cosa_tpu.ops re-exports a function named ``resize`` over the module name
jimage = importlib.import_module("cosa_tpu.ops.image")
jresize = importlib.import_module("cosa_tpu.ops.resize")
from cosa_tpu_torch.ops import image as timage
from cosa_tpu_torch.ops import resize as tresize

TOL = 1e-5


def _img(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_normalize_and_denormalize_match_jax():
    u8 = np.random.default_rng(1).integers(0, 256, (2, 9, 11, 3)).astype(np.uint8)
    for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        a = timage.normalize(torch.from_numpy(u8), dtype=dt_t).float().numpy()
        b = np.asarray(jimage.normalize(jnp.asarray(u8), dtype=dt_j), np.float32)
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    x = _img((2, 9, 11, 3)) * 2.0
    a = timage.denormalize_u8(torch.from_numpy(x)).numpy()
    b = np.asarray(jimage.denormalize_u8(jnp.asarray(x)))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        timage.denormalize01(torch.from_numpy(x)).numpy(),
        np.asarray(jimage.denormalize01(jnp.asarray(x))))
    np.testing.assert_array_equal(
        timage.hflip(torch.from_numpy(x)).numpy(), np.asarray(jimage.hflip(jnp.asarray(x))))


SIZES = [
    ((2, 64, 64, 3), (32, 32)),
    ((2, 64, 64, 3), (96, 96)),
    ((1, 40, 44, 2), (313, 29)),  # ragged, as 448 * 0.7 = 313 at a TTA scale
    ((2, 28, 28, 5), (56, 56)),
    ((1, 17, 23, 4), (17, 23)),  # identity
]


@pytest.mark.parametrize("shape,size", SIZES)
@pytest.mark.parametrize("flip_w", [False, True])
def test_bilinear_matches_jax(shape, size, flip_w):
    x = _img(shape)
    a = tresize.resize_bilinear(torch.from_numpy(x), size, flip_w=flip_w).numpy()
    b = np.asarray(jresize.resize_bilinear(jnp.asarray(x), size, flip_w=flip_w))
    np.testing.assert_allclose(a, b, atol=TOL * np.abs(x).max(), rtol=0)
    if flip_w:  # flip_w is exactly resize followed by a flip
        plain = tresize.resize_bilinear(torch.from_numpy(x), size)
        np.testing.assert_array_equal(a, torch.flip(plain, dims=(-2,)).numpy())


@pytest.mark.parametrize("shape,size", SIZES)
def test_bicubic_and_nearest_match_jax(shape, size):
    x = _img(shape, seed=3)
    a = tresize.resize_bicubic(torch.from_numpy(x), size).numpy()
    b = np.asarray(jresize.resize_bicubic(jnp.asarray(x), size))
    np.testing.assert_allclose(a, b, atol=TOL * np.abs(x).max(), rtol=0)
    a = tresize.resize_nearest(torch.from_numpy(x), size).numpy()
    b = np.asarray(jresize.resize_nearest(jnp.asarray(x), size))
    np.testing.assert_array_equal(a, b)
    lab = np.random.default_rng(4).integers(0, 21, shape[:3]).astype(np.int32)
    a = tresize.resize_nearest(torch.from_numpy(lab), size).numpy()
    b = np.asarray(jresize.resize_nearest(jnp.asarray(lab)[..., None], size))[..., 0]
    np.testing.assert_array_equal(a, b)
