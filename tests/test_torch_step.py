"""PyTorch port vs the JAX package: one whole co-training step.

Configuration of test_full_step_oracle.py (tiny ViT, crop 64, batch 2,
f32, two TTA scales, gate open, energy weight 1), run with the exact, the
RFF and the lattice energy filter (the JAX package's lattice built before
its step, the port's inside it), once with GMM thresholds and PAR on, with one
seeded queue injected into both (the JAX package draws its queues from
jax.random), once each with the MaskTransformer decoder and with the
distilled DeiT backbone, and twice with the zoo's Swin co-training family
(``swinend2end``, once with ``use_cammix``). Student and teacher start
from different JAX inits carried into the port with state_dict_from_jax;
the same batch goes to
both steps. Every metric is held to that file's tolerances; after the step
every student and teacher tensor (pos_embed included) agrees within 1e-5
of its largest value, and no less than 1e-8: a tensor that starts at zero
holds only the first update, lr-sized (6e-11 here), whose sign is
arbitrary where the gradient is rounding noise (the key bias has a zero
true gradient). The logged lr is equal."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.models import build_model as jax_build_model
from cosa_tpu.train import build_optimizer as jax_build_optimizer
from cosa_tpu.train import build_train_step as jax_build_train_step
from cosa_tpu.train.state import TrainState as JaxTrainState
from cosa_tpu.train.state import init_gmm_state
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.models.convert import state_dict_from_jax
from cosa_tpu_torch.train.optimizer import GroupOptimizer, param_label
from cosa_tpu_torch.train.state import create_train_state
from cosa_tpu_torch.train.step import build_train_step

CROP = 64
# test_full_step_oracle.py:172-177
TOLS = dict(cls_loss=2e-3, cls_aux_loss=2e-3, seg_loss=5e-3, cam_loss=2e-3,
            reg_loss=2e-2, overall_loss=5e-3)


def _kw(kind, **extra):
    return {**dict(backbone="vit_tiny_test", num_classes=6, crop_size=CROP, batch_size=2,
                   mixed_precision=False, flash_attention=False, aux_layer=-2,
                   pseudo_scales=(1.0, 0.5), warmup_iters=-1, energy_filter=kind,
                   energy_weight=1.0, energy_convention=0.6, aux_cam2seg=True,
                   aux_seg2cam=False, detach="none"), **extra}


# GMM on both heads (usegmmaux follows usegmm) and PAR: queues of 2 x 4 rows
# of (64 / 16)^2 CAM maxima, two PAR dilations
GMM_PAR = dict(usegmm=True, usepar=True, queue_update_ratio=4, par_dilations=(1, 2))
# the other architectures: the MaskTransformer decoder, the distilled DeiT
MASKFORMER = dict(decoder="Maskformer")
DISTILLED = dict(backbone="deit_tiny_test_distilled")
# the zoo's co-training family: Swin (drop path 0 in swin_tiny_test); the
# aux tap (-2 of 4 blocks) is 64 wide at /16, cam 128 wide at /32, so
# use_cammix mixes the two CAM sizes after the TTA fuse
SWIN = dict(model="swinend2end", backbone="swin_tiny_test")
SWIN_CAMMIX = dict(SWIN, use_cammix=True)


def _batch():
    rng = np.random.default_rng(0)
    cls_label = np.zeros((2, 5), np.float32)
    cls_label[0, [0, 2]] = 1
    cls_label[1, [1, 4]] = 1
    return dict(
        wimg=rng.integers(0, 255, (2, CROP, CROP, 3)).astype(np.uint8),
        simg=rng.integers(0, 255, (2, CROP, CROP, 3)).astype(np.uint8),
        cls_label=cls_label,
        img_box=np.array([[0, CROP, 0, CROP], [4, 60, 2, 62]], np.int32),
    )


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _assert_params(module, jax_params, what):
    ref = state_dict_from_jax(_np_tree(jax_params))
    ours = module.state_dict()
    assert set(ours) == set(ref)
    for k, r in ref.items():
        a, r = ours[k].numpy(), r.numpy()
        assert np.abs(a - r).max() <= 1e-5 * max(np.abs(r).max(), 1e-3), (what, k)


@pytest.mark.parametrize("kind,extra", [("exact", {}), ("rff", {}), ("lattice", {}),
                                        ("rff", GMM_PAR), ("rff", MASKFORMER),
                                        ("rff", DISTILLED), ("rff", SWIN),
                                        ("rff", SWIN_CAMMIX)],
                         ids=["exact", "rff", "lattice", "rff-gmm-par", "rff-maskformer",
                              "rff-distilled", "rff-swin", "rff-swin-cammix"])
def test_train_step_matches_jax(kind, extra):
    check_step_against_jax(kind, extra)


def check_step_against_jax(kind, extra):
    """One step of the port against the JAX package's from the same state
    and batch (this module's docstring); tests/test_torch_int8.py runs it
    with the int8 teacher."""
    from cosa_tpu.objectives.energy import build_energy_lattice as jax_lattice

    batch = _batch()
    cfg_j = jax_preset("synthetic", **_kw(kind, **extra))
    model = jax_build_model(cfg_j)
    dummy = jnp.zeros((1, CROP, CROP, 3))
    student = model.init(jax.random.PRNGKey(0), dummy)["params"]
    teacher = model.init(jax.random.PRNGKey(1), dummy)["params"]
    tx = jax_build_optimizer(cfg_j, student)
    gmm_j = init_gmm_state(cfg_j, 2)
    queues = np.random.default_rng(7).random((2,) + gmm_j.queue.shape).astype(np.float32)
    gmm = extra.get("usegmm", False)
    if gmm:
        gmm_j = gmm_j.replace(queue=jnp.asarray(queues[0]), queue_aux=jnp.asarray(queues[1]))
    state_j = JaxTrainState(step=jnp.zeros((), jnp.int32), student=student,
                            teacher=teacher, opt_state=tx.init(student), gmm=gmm_j)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    if kind == "lattice":
        batch_j["energy_lattice"] = jax_lattice(cfg_j, batch_j["simg"])
    new_j, m_j = jax.jit(jax_build_train_step(cfg_j, model, tx))(state_j, batch_j)

    cfg_t = torch_preset("synthetic", **_kw(kind, **extra))
    state_t = create_train_state(cfg_t, "cpu")
    state_t.student.load_state_dict(state_dict_from_jax(_np_tree(student)))
    state_t.teacher.load_state_dict(state_dict_from_jax(_np_tree(teacher)))
    if gmm:
        state_t.gmm.queue = torch.from_numpy(queues[0].copy())
        state_t.gmm.queue_aux = torch.from_numpy(queues[1].copy())
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    m_t = build_train_step(cfg_t)(state_t, batch_t)

    for k, tol in TOLS.items():
        ours, ref = float(m_t[k]), float(m_j[k])
        assert abs(ours - ref) <= tol * max(abs(ref), 1e-3), (k, ours, ref)
    assert np.float32(m_t["lr"]) == np.float32(m_j["lr"])
    assert state_t.step == int(new_j.step) == 1
    _assert_params(state_t.student, new_j.student, "student")
    _assert_params(state_t.teacher, new_j.teacher, "teacher")
    if gmm:  # the GMM state after the step: queues, pointer and the EMAs
        g_t, g_j = state_t.gmm, new_j.gmm
        assert g_t.ptr == int(g_j.ptr) == 2
        for name in ("queue", "queue_aux", "ema_low", "ema_high", "ema_low_aux",
                     "ema_high_aux"):
            a, r = getattr(g_t, name).numpy(), np.asarray(getattr(g_j, name))
            assert np.abs(a - r).max() <= 1e-5, (name, a, r)
        assert float(m_t["thre_low"]) == float(g_t.ema_low)


def test_optimizer_groups_match_optax():
    """Three PolyWarmupAdamW updates on fixed gradients, at a real lr (warmup
    2, so step 2 is past it), against the JAX package's optax chain."""
    kw = dict(backbone="vit_tiny_test", num_classes=6, lr_warmup_iters=2, max_iters=10,
              lrscale=10.0, wt_dec=1e-2)
    cfg_j = jax_preset("synthetic", **kw)
    model = jax_build_model(cfg_j)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))["params"]
    tx = jax_build_optimizer(cfg_j, params)
    opt = tx.init(params)
    state_t = create_train_state(torch_preset("synthetic", **kw), "cpu")
    state_t.student.load_state_dict(state_dict_from_jax(_np_tree(params)))
    rng = np.random.default_rng(5)
    for step in range(3):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)), params)
        upd, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, upd)
        gsd = state_dict_from_jax(_np_tree(grads))
        for name, p in state_t.student.named_parameters():
            p.grad = None if param_label(name) == "frozen" else gsd[name].clone()
        state_t.optimizer.step(step)
    _assert_params(state_t.student, params, "student")


def test_optimizer_rejects_unported_kinds():
    """Every kind the JAX package knows is ported (tests/test_torch_optim.py
    holds them); any other kind is refused by the config and by the
    optimizer itself."""
    with pytest.raises(AssertionError):
        torch_preset("synthetic", backbone="vit_tiny_test", optimizer="adam")
    cfg = dataclasses.replace(torch_preset("synthetic", backbone="vit_tiny_test"),
                              optimizer="adam")
    with pytest.raises(ValueError, match="adam"):
        GroupOptimizer(cfg, torch.nn.Linear(2, 2))
