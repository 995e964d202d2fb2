"""PyTorch port vs the JAX package: pseudo labels, losses, bilateral
filtering and the dense-energy regularizer (f32 unless stated).

Tolerances: 1e-5 on pseudo-label maps and losses (f32, sums in another
order); 1e-4 relative on the energy and its gradient (a sum over N^2
Gaussian weights or N x 1024 random features)."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.objectives import energy as jenergy
from cosa_tpu.objectives import losses as jlosses
from cosa_tpu.objectives import pseudo as jpseudo
from cosa_tpu.ops import bilateral as jbil
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.kernels.tta_fuse import minmax_norm
from cosa_tpu_torch.objectives import energy as tenergy
from cosa_tpu_torch.objectives import losses as tlosses
from cosa_tpu_torch.objectives import pseudo as tpseudo
from cosa_tpu_torch.ops import bilateral as tbil

jresize = importlib.import_module("cosa_tpu.ops.resize")
TOL = 1e-5
BOXES = np.array([[0, 24, 0, 24], [3, -2, 5, -1], [0, -1, 0, -1], [23, 24, 0, 1]], np.int32)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def test_box_mask_and_minmax_norm():
    a = tpseudo.box_mask(_t(BOXES), 24, 24).numpy()
    b = np.asarray(jpseudo.box_mask(jnp.asarray(BOXES), 24, 24))
    np.testing.assert_array_equal(a, b)
    x = _rng(0).standard_normal((2, 9, 7, 3)).astype(np.float32)
    _close(minmax_norm(_t(x)), jpseudo.minmax_norm(jnp.asarray(x)))


@pytest.mark.parametrize("scales", [(1.0, 0.5, 1.5), (1.0,), (0.5, 1.0)])
def test_multi_scale_camseg_matches_jax(scales):
    x = _rng(1).standard_normal((2, 32, 40, 3)).astype(np.float32)
    w = _rng(7).standard_normal((3, 16)).astype(np.float32)

    def jf(xx):
        y = jresize.resize_bilinear(xx, (xx.shape[1] // 4, xx.shape[2] // 4)) @ jnp.asarray(w)
        return dict(cam=y[..., :5], cam_aux=y[..., 5:10], seg=y[..., 10:16],
                    cls=y[..., :5].mean(axis=(1, 2)), cls_aux=y[..., 5:10].mean(axis=(1, 2)))

    def tf(xx):
        from cosa_tpu_torch.ops.resize import resize_bilinear
        y = resize_bilinear(xx, (xx.shape[1] // 4, xx.shape[2] // 4)) @ _t(w)
        return dict(cam=y[..., :5], cam_aux=y[..., 5:10], seg=y[..., 10:16],
                    cls=y[..., :5].mean(dim=(1, 2)), cls_aux=y[..., 5:10].mean(dim=(1, 2)))

    ours = tpseudo.multi_scale_camseg(tf, _t(x), scales, getcls=True)
    ref = jpseudo.multi_scale_camseg(jf, jnp.asarray(x), scales, getcls=True)
    for a, b in zip(ours, ref):
        _close(a, b, 2e-5 * max(1.0, float(np.abs(np.asarray(b)).max())))


def test_validation_refine_and_cam_to_label():
    rng = _rng(2)
    cam = rng.uniform(0, 1, (4, 24, 24, 5)).astype(np.float32)
    lab = (rng.uniform(size=(4, 5)) > 0.5).astype(np.float32)
    _close(tpseudo.cam_validation(_t(cam), _t(lab)), jpseudo.cam_validation(jnp.asarray(cam), jnp.asarray(lab)))
    seg = rng.standard_normal((4, 24, 24, 6)).astype(np.float32)
    for after in (False, True):
        _close(tpseudo.seg_refine_by_label(_t(seg), _t(lab), 0.01, after),
               jpseudo.seg_refine_by_label(jnp.asarray(seg), jnp.asarray(lab), 0.01, after))
    np.testing.assert_array_equal(
        tpseudo.cam_to_label(_t(cam), _t(lab)).numpy(),
        np.asarray(jpseudo.cam_to_label(jnp.asarray(cam), jnp.asarray(lab))))
    for mid in (False, True):
        va, la = tpseudo.cam_to_label(_t(cam), _t(lab), _t(BOXES), 0.5, 0.7, 0.25, mid)
        vb, lb = jpseudo.cam_to_label(jnp.asarray(cam), jnp.asarray(lab), jnp.asarray(BOXES),
                                      0.5, 0.7, 0.25, mid)
        _close(va, vb)
        np.testing.assert_array_equal(la.numpy(), np.asarray(lb))


@pytest.mark.parametrize("downscale", [2, 0])
def test_cam2mask_matches_jax(downscale):
    rng = _rng(3)
    cam = rng.uniform(0, 1, (4, 24, 24, 5)).astype(np.float32)
    lab = (rng.uniform(size=(4, 5)) > 0.4).astype(np.float32)
    lab[0] = 0  # an image with no foreground class
    vc = cam * lab[:, None, None, :]
    a = tpseudo.cam2mask(_t(BOXES), _t(vc), _t(lab), 0.7, 0.25, downscale)
    b = jpseudo.cam2mask(jnp.asarray(BOXES), jnp.asarray(vc), jnp.asarray(lab),
                         0.7, 0.25, downscale)
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_losses_and_grads_match_jax():
    rng = _rng(4)
    logits = rng.standard_normal((3, 5)).astype(np.float32) * 3
    tgt = (rng.uniform(size=(3, 5)) > 0.5).astype(np.float32)
    x = _t(logits).requires_grad_(True)
    lt = tlosses.multilabel_soft_margin(x, _t(tgt))
    lt.backward()
    lj, gj = jax.value_and_grad(jlosses.multilabel_soft_margin)(jnp.asarray(logits), jnp.asarray(tgt))
    _close(lt.detach(), lj)
    _close(x.grad, gj)

    seg = rng.standard_normal((2, 12, 12, 6)).astype(np.float32)
    mask = rng.integers(0, 6, (2, 12, 12)).astype(np.int32)
    mask[rng.uniform(size=mask.shape) < 0.3] = 255
    s = _t(seg).requires_grad_(True)
    lt = tlosses.seg_loss(s, _t(mask), 0.5)
    lt.backward()
    lj, gj = jax.value_and_grad(jlosses.seg_loss)(jnp.asarray(seg), jnp.asarray(mask), 0.5)
    _close(lt.detach(), lj)
    _close(s.grad, gj)


@pytest.mark.parametrize("version", ["v1", "v2", "v3"])
def test_cam_losses_match_jax(version):
    rng = _rng(5)
    cam = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    seg_ps = jax.nn.softmax(jnp.asarray(rng.standard_normal((2, 32, 32, 6)).astype(np.float32)) * 3)
    seg_ps = np.asarray(seg_ps)
    fn_t = getattr(tlosses, f"cam_loss_{version}")
    fn_j = getattr(jlosses, f"cam_loss_{version}")
    _close(fn_t(_t(cam), _t(seg_ps)), fn_j(jnp.asarray(cam), jnp.asarray(seg_ps)))


def test_rff_params_bit_equal():
    for n, d, seed in ((1024, 5, 0), (256, 5, 3), (100, 3, 1)):
        wt, bt = tbil._rff_params(n, d, seed)
        wj, bj = jbil._rff_params(n, d, seed)
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_array_equal(bt, bj)


def test_pixel_features_and_filters_match_jax():
    rng = _rng(6)
    img = rng.integers(0, 256, (2, 10, 12, 3)).astype(np.float32)
    ft = tbil.pixel_features(_t(img), 15.0, 50.0)
    fj = jbil.pixel_features(jnp.asarray(img), 15.0, 50.0)
    _close(ft, fj)
    f = np.asarray(fj).reshape(2, 120, 5)
    v = rng.uniform(size=(2, 120, 4)).astype(np.float32)
    _close(tbil.exact_gaussian_filter(_t(f), _t(v)),
           jbil.exact_gaussian_filter(jnp.asarray(f), jnp.asarray(v)), 1e-4)
    for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        a = tbil.rff_gaussian_filter(_t(f), _t(v), 256, 0, dt_t)
        b = jbil.rff_gaussian_filter(jnp.asarray(f), jnp.asarray(v), 256, 0, dt_j)
        _close(a, b, 1e-4 * float(np.abs(np.asarray(b)).max()))


@pytest.mark.parametrize("kind", ["rff", "exact"])
def test_energy_loss_and_seg_grad_match_jax(kind):
    rng = _rng(8)
    b, h, w, c = 2, 32, 32, 5
    img_u8 = rng.integers(0, 256, (b, h, w, 3)).astype(np.float32)
    mean = np.array([123.675, 116.28, 103.53], np.float32)
    std = np.array([58.395, 57.12, 57.375], np.float32)
    img = (img_u8 - mean) / std
    seg = rng.standard_normal((b, h, w, c)).astype(np.float32) * 2
    label = rng.integers(0, c, (b, h, w)).astype(np.int32)
    label[:, :4] = 255
    box = np.array([[0, 32, 0, 32], [2, 30, 4, 28]], np.int32)
    kw = dict(weight=1.0, filter_kind=kind, rff_features=256, convention=0.6)

    s = _t(seg).requires_grad_(True)
    lt = tenergy.get_energy_loss(_t(img), s, _t(label), _t(box), **kw)
    lt.backward()
    lj, gj = jax.value_and_grad(
        lambda x: jenergy.get_energy_loss(jnp.asarray(img), x, jnp.asarray(label),
                                          jnp.asarray(box), **kw)
    )(jnp.asarray(seg))
    lt = float(lt.detach())
    assert abs(lt - float(lj)) <= 1e-4 * abs(float(lj)), (lt, float(lj))
    gj = np.asarray(gj)
    assert np.abs(s.grad.numpy() - gj).max() <= 1e-4 * np.abs(gj).max()


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_resolve_energy_convention_matches_jax(mixed_precision):
    kw = dict(num_classes=6, crop_size=48, mixed_precision=mixed_precision)
    imgs = _rng(9).integers(0, 256, (4, 48, 48, 3)).astype(np.uint8)
    ct, _ = tenergy.resolve_energy_convention(torch_preset("synthetic", **kw), imgs)
    cj, _ = jenergy.resolve_energy_convention(jax_preset("synthetic", **kw), imgs)
    assert abs(ct - cj) <= 1e-4 * abs(cj), (ct, cj)
