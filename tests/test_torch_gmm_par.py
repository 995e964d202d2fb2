"""PyTorch port vs the JAX package: GMM thresholds, PAR, the align-corners
resize, cam2mask with a refine step, and the GMM state.

Tolerances: fit_gmm_1d's means, variances and weights within 1e-4
relative; gmm_thresholds' low and high within 1e-5; par_refine within
rtol 1e-4 / atol 1e-5 (the JAX package's own bound against the reference
algorithm, tests/test_par_gmm.py); resize_bilinear_ac within 1e-5; the
masks of cam2mask with PAR and tensor thresholds equal on >= 99.9% of the
pixels."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosa_tpu.objectives.pseudo import cam2mask as jax_cam2mask
from cosa_tpu.ops import gmm as jax_gmm
from cosa_tpu.ops import par as jax_par
from cosa_tpu_torch.config import preset_config
from cosa_tpu_torch.objectives.pseudo import cam2mask
from cosa_tpu_torch.ops import gmm, par
from cosa_tpu_torch.ops.resize import resize_bilinear_ac
from cosa_tpu_torch.train import checkpoint
from cosa_tpu_torch.train.state import create_train_state, init_gmm_state

jax_resize = importlib.import_module("cosa_tpu.ops.resize")


def _trimodal(seed=0):
    """CAM-max-like queue values in [0, 1] (tests/test_par_gmm.py's data)."""
    r = np.random.default_rng(seed)
    return np.concatenate([r.normal(0.15, 0.05, 2000), r.normal(0.5, 0.08, 1500),
                           r.normal(0.85, 0.05, 1500)]).clip(0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("k,iters", [(3, 25), (3, 100), (2, 25)])
def test_fit_gmm_matches_jax(k, iters):
    x = _trimodal()
    ref = jax_gmm.fit_gmm_1d(jnp.asarray(x), jnp.asarray(x > 0.05), k, iters)
    ours = gmm.fit_gmm_1d(torch.from_numpy(x), torch.from_numpy(x > 0.05), k, iters)
    for name, a, r in zip(("means", "vars", "weights"), ours[:3], ref[:3]):
        r = np.asarray(r)
        assert np.abs(a.numpy() - r).max() <= 1e-4 * np.abs(r).max(), name


@pytest.mark.parametrize("iters,subsample", [(100, 8), (25, 1)])
def test_gmm_thresholds_match_jax(iters, subsample):
    q = _trimodal(1).reshape(10, 500)
    ref = jax_gmm.gmm_thresholds(jnp.asarray(q), 0.05, 3, iters, subsample)
    ours = gmm.gmm_thresholds(torch.from_numpy(q), 0.05, 3, iters, subsample)
    for a, r in zip(ours, ref):
        assert a.dim() == 0 and abs(float(a) - float(r)) <= 1e-5
    assert 0.0 < float(ours[0]) < float(ours[1]) < 1.0


def test_par_matches_jax():
    r = np.random.default_rng(0)
    imgs = r.random((2, 24, 20, 3)).astype(np.float32)
    masks = r.random((2, 12, 10, 4)).astype(np.float32)
    ref = jax_par.par_refine(jnp.asarray(imgs), jnp.asarray(masks), dilations=(1, 2, 4),
                             num_iter=3)
    ours = par.par_refine(torch.from_numpy(imgs), torch.from_numpy(masks),
                          dilations=(1, 2, 4), num_iter=3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    aff = par.par_affinity(torch.from_numpy(imgs), (1, 2, 4)).numpy()
    np.testing.assert_allclose(aff, np.asarray(jax_par.par_affinity(jnp.asarray(imgs), (1, 2, 4))),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("size", [(23, 17), (6, 5), (12, 10)])
def test_resize_bilinear_ac_matches_jax(size):
    x = np.random.default_rng(1).random((2, 12, 10, 4)).astype(np.float32)
    ref = np.asarray(jax_resize.resize_bilinear_ac(jnp.asarray(x), size))
    ours = resize_bilinear_ac(torch.from_numpy(x), size).numpy()
    assert np.abs(ours - ref).max() <= 1e-5


def test_cam2mask_with_par_and_tensor_thresholds_matches_jax():
    r = np.random.default_rng(2)
    b, h, w, c = 2, 32, 32, 5
    cams = r.random((b, h, w, c)).astype(np.float32)
    cls = np.array([[1, 0, 1, 0, 0], [0, 1, 0, 0, 1]], np.float32)
    cams *= cls[:, None, None]
    imgs = r.random((b, h, w, 3)).astype(np.float32)
    box = np.array([[0, h, 0, w], [2, 30, 1, 31]], np.int32)
    lo, hi = np.float32(0.3), np.float32(0.6)
    ref = np.asarray(jax_cam2mask(
        img_box=jnp.asarray(box), cams=jnp.asarray(cams), cls_labels=jnp.asarray(cls),
        threshold_high=jnp.asarray(hi), threshold_low=jnp.asarray(lo),
        refine_fn=lambda i, p: jax_par.par_refine(i, p, dilations=(1, 2), num_iter=3),
        images=jnp.asarray(imgs)))
    ours = cam2mask(
        img_box=torch.from_numpy(box), cams=torch.from_numpy(cams),
        cls_labels=torch.from_numpy(cls), threshold_high=torch.tensor(hi),
        threshold_low=torch.tensor(lo),
        refine_fn=lambda i, p: par.par_refine(i, p, dilations=(1, 2), num_iter=3),
        images=torch.from_numpy(imgs)).numpy()
    assert (ours == ref).mean() >= 0.999
    with pytest.raises(ValueError, match="images"):
        cam2mask(img_box=torch.from_numpy(box), cams=torch.from_numpy(cams),
                 cls_labels=torch.from_numpy(cls), threshold_high=0.6, threshold_low=0.3,
                 refine_fn=lambda i, p: p)


def test_gmm_state_is_seeded_and_checkpointed(tmp_path):
    """The queues: global_batch * queue_update_ratio rows of (crop /
    gmmscale)^2 values, the same for the same seed; 1 x 1 when GMM is off.
    A checkpoint round trip restores queues, pointer and EMAs."""
    kw = dict(backbone="vit_tiny_test", crop_size=64, batch_size=2, usegmm=True,
              queue_update_ratio=3)
    cfg = preset_config("synthetic", **kw)
    a, b = init_gmm_state(cfg, 2), init_gmm_state(cfg, 2)
    assert a.queue.shape == (6, 16) and torch.equal(a.queue, b.queue)
    assert not torch.equal(a.queue, a.queue_aux)
    assert init_gmm_state(cfg.replace(usegmm=False), 2).queue.shape == (1, 1)
    assert init_gmm_state(cfg.replace(usegmm=False, usegmmaux=True), 2).queue.shape == (6, 16)

    state = create_train_state(cfg, "cpu")
    state.gmm.ptr = 4
    state.gmm.ema_low = torch.tensor(0.125)
    state.gmm.queue_aux[1] = 0.5
    checkpoint.save_state(str(tmp_path), state, 7)
    other = create_train_state(cfg, "cpu")
    checkpoint.restore_state(str(tmp_path), other)
    assert other.gmm.ptr == 4 and other.step == 7
    for k in other.gmm.TENSORS:
        assert torch.equal(getattr(other.gmm, k), getattr(state.gmm, k)), k


def test_usegmmaux_alone_moves_only_the_aux_thresholds():
    """usegmm off and usegmmaux on: the step logs the fixed main pair, the
    aux queue takes the batch's rows from the old pointer and the aux EMAs
    move; the main queue and EMAs stay as they were."""
    from cosa_tpu_torch.train.step import build_train_step

    cfg = preset_config("synthetic", backbone="vit_tiny_test", crop_size=64, batch_size=2,
                        mixed_precision=False, flash_attention=False, pseudo_scales=(1.0,),
                        usegmm=False, usegmmaux=True, queue_update_ratio=2,
                        energy_convention=0.6, aux_cam2seg=True)
    state = create_train_state(cfg, "cpu")
    main, aux = state.gmm.queue.clone(), state.gmm.queue_aux.clone()
    rng = np.random.default_rng(4)
    batch = dict(wimg=torch.from_numpy(rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)),
                 simg=torch.from_numpy(rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)),
                 cls_label=torch.tensor([[1, 0, 0, 1, 0] + [0] * 15, [0, 1] + [0] * 18]),
                 img_box=torch.tensor([[0, 64, 0, 64], [0, 64, 0, 64]]))
    m = build_train_step(cfg)(state, batch)
    g = state.gmm
    assert (float(m["thre_low"]), float(m["thre_high"])) == (0.25, np.float32(0.7))
    assert torch.equal(g.queue, main) and g.ptr == 2
    assert torch.equal(g.queue_aux[2:], aux[2:]) and not torch.equal(g.queue_aux[:2], aux[:2])
    assert (float(g.ema_low), float(g.ema_high)) == (0.25, np.float32(0.7))
    assert (float(g.ema_low_aux), float(g.ema_high_aux)) != (0.25, np.float32(0.7))
