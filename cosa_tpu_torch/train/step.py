"""The co-training step (the JAX package's train/step.py::build_train_step,
itself covering the reference's main.py:106-252):

  teacher multi-scale TTA  (weak image, no grad)
  GMM adaptive thresholds  (ring buffer + fixed-iteration EM, ``usegmm``)
  CAM -> pseudo mask       (batched cam2mask, main and aux heads; PAR
                            refinement with ``usepar``)
  seg -> CAM soft targets
  student forward/backward (strong image): cls, seg, cam and energy losses
  PolyWarmupAdamW update
  EMA teacher update       (f32, every parameter)

Eager PyTorch updates the state in place: the step returns only its
metrics. Each phase runs under a ``torch.profiler.record_function`` span
(teacher_tta, gmm, pseudo_labels, student_forward, losses, energy,
backward, optimizer, ema), which ``torch.profiler`` reads and which cost next to
nothing without one. Loss weighting (main.py:240-243): the
cls losses are always on; seg/cam/reg are scaled by ``warmup_gate_floor``
while step <= warmup_iters.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import numpy as np
import torch
from torch.profiler import record_function

from cosa_tpu_torch.models.network import require_cosa_interface
from cosa_tpu_torch.objectives.energy import get_energy_loss
from cosa_tpu_torch.objectives.losses import (
    cam_loss_v1,
    cam_loss_v2,
    cam_loss_v3,
    multilabel_soft_margin,
    seg_loss,
)
from cosa_tpu_torch.objectives.pseudo import (
    cam2mask,
    cam_validation,
    multi_scale_camseg,
    seg_refine_by_label,
)
from cosa_tpu_torch.ops.gmm import gmm_thresholds
from cosa_tpu_torch.ops.image import denormalize01, normalize
from cosa_tpu_torch.ops.par import par_refine
from cosa_tpu_torch.ops.resize import resize_bilinear
from cosa_tpu_torch.train.state import GMMState, TrainState, ema_update, use_gmm_aux


def _update_queue(queue: torch.Tensor, ptr: int, rows: torch.Tensor) -> int:
    """Ring-buffer write (reference DynamicQueue.update, seg_helper.py:953-956)
    at ``ptr``, in place, clamped so the rows fit as the JAX package's
    dynamic_update_slice does. Returns the next pointer."""
    b, q = rows.shape[0], queue.shape[0]
    start = min(max(ptr, 0), q - b)
    queue[start:start + b] = rows
    return (ptr + b) % q


def _gmm_maxrow(valid_cam: torch.Tensor, gmmscale: int) -> torch.Tensor:
    """(B, H, W, C) validated CAM -> (B, (H/s)*(W/s)) rows of its spatial
    max map (main.py:139-143)."""
    h, w = valid_cam.shape[1:3]
    red = resize_bilinear(valid_cam, (h // gmmscale, w // gmmscale))
    return red.amax(dim=-1).reshape(valid_cam.shape[0], -1)


def _gmm_update(cfg, gmm: GMMState, valid_cam, valid_cam_aux) -> None:
    """The JAX package's GMM update (train/step.py:151-180), in place: each
    head with GMM on writes its rows from the OLD pointer, refits its
    thresholds on its queue and moves their EMAs."""
    d = cfg.gmmemadecay
    ptr = gmm.ptr
    for on, cam, q, lo_k, hi_k in (
            (cfg.usegmm, valid_cam, "queue", "ema_low", "ema_high"),
            (use_gmm_aux(cfg), valid_cam_aux, "queue_aux", "ema_low_aux", "ema_high_aux")):
        if not on:
            continue
        queue = getattr(gmm, q)
        gmm.ptr = _update_queue(queue, ptr, _gmm_maxrow(cam, cfg.gmmscale))
        lo, hi = gmm_thresholds(queue, cfg.gmmfilter_thre, 3, cfg.gmm_em_iters,
                                cfg.gmm_em_subsample)
        setattr(gmm, lo_k, getattr(gmm, lo_k) * d + lo * (1 - d))
        setattr(gmm, hi_k, getattr(gmm, hi_k) * d + hi * (1 - d))


def drop_path_generator(seed: int, step: int, device) -> torch.Generator:
    """The student's stochastic-depth draws of ``step``: a generator on
    ``device`` seeded from ``(seed, step)`` alone, so a resumed run draws
    the masks of the straight one (the JAX package folds the step into
    ``PRNGKey(seed)``; torch's numbers cannot equal jax.random's)."""
    key = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(key)


def build_train_step(cfg) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict]:
    require_cosa_interface(cfg)
    camloss_fn = {
        "v1": cam_loss_v1,
        "v2": cam_loss_v2,
        "v3": partial(cam_loss_v3, seg_confident_thre=cfg.segconf_thre),
    }[cfg.camloss_version]
    energy_convention = float(cfg.energy_convention)
    if cfg.energy_filter == "rff" and energy_convention <= 0:
        raise ValueError(
            "cfg.energy_convention is unresolved (0.0 = auto). Call "
            "objectives.energy.resolve_energy_convention on a real batch "
            "first (train() does this), or set it explicitly."
        )
    mp = cfg.mixed_precision
    act_dtype = torch.bfloat16 if mp else torch.float32
    gmm_main, gmm_aux = bool(cfg.usegmm), use_gmm_aux(cfg)
    refine_fn = None
    if cfg.usepar:
        def refine_fn(imgs, probs):
            return par_refine(imgs, probs, dilations=cfg.par_dilations,
                              num_iter=cfg.par_iters)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
        wimg = normalize(batch["wimg"], dtype=act_dtype)
        simg = normalize(batch["simg"])
        cls_label = batch["cls_label"].to(torch.float32)
        img_box = batch["img_box"]
        h, w = simg.shape[1:3]

        # ---- teacher TTA pseudo labels (no grad) -----------------------
        with torch.no_grad():
            with record_function("teacher_tta"):
                cam_ps, cam_aux_ps, seg_ps = multi_scale_camseg(
                    state.teacher, wimg, cfg.pseudo_scales, cam_dtype=act_dtype
                )
            cam_src = (cam_ps + cam_aux_ps) / 2 if cfg.use_cammix else cam_ps
            valid_cam = cam_validation(cam_src, cls_label)
            valid_cam_aux = cam_validation(cam_aux_ps, cls_label)
            if gmm_main or gmm_aux:
                with record_function("gmm"):
                    _gmm_update(cfg, state.gmm, valid_cam, valid_cam_aux)
            g = state.gmm
            # the logged pair is a 0-d tensor on the device either way
            thre = (g.ema_low, g.ema_high) if gmm_main else tuple(
                torch.full((), v, dtype=torch.float32, device=simg.device)
                for v in (cfg.low_thre, cfg.high_thre))
            thre_aux = ((g.ema_low_aux, g.ema_high_aux) if gmm_aux
                        else (cfg.low_thre_aux, cfg.high_thre_aux))
            with record_function("pseudo_labels"):
                mask_kwargs = dict(img_box=img_box, cls_labels=cls_label,
                                   downscale=cfg.par_downscale,
                                   ignore_index=cfg.ignore_index, refine_fn=refine_fn,
                                   images=denormalize01(simg) if cfg.usepar else None)
                refine_mask = cam2mask(cams=valid_cam, threshold_high=thre[1],
                                       threshold_low=thre[0], **mask_kwargs)
                if cfg.aux_cam2seg:
                    refine_mask_aux = cam2mask(cams=valid_cam_aux, threshold_high=thre_aux[1],
                                               threshold_low=thre_aux[0], **mask_kwargs)
                valid_seg_ps = seg_refine_by_label(
                    seg_ps, cls_label, softmaxtemp=cfg.seg_softmaxtemp,
                    after_softmax=cfg.after_softmax,
                )

        # ---- student loss ------------------------------------------------
        # the Swin student trains with live stochastic depth (torch
        # .train() makes the reference MMSWIN's DropPath live); the teacher
        # and evaluation stay deterministic
        student_kw = {}
        if cfg.model == "swinend2end":
            student_kw = dict(train=True, generator=drop_path_generator(
                cfg.seed, state.step, simg.device))
        with record_function("student_forward"):
            out = state.student(simg, detach=cfg.detach, **student_kw)
        with record_function("losses"):
            cls_loss = multilabel_soft_margin(out["cls"], cls_label)
            cls_aux_loss = multilabel_soft_margin(out["cls_aux"], cls_label)
            seg_pred = resize_bilinear(out["seg"], (h, w))
            sl = seg_loss(seg_pred, refine_mask, fg_alpha=cfg.segfg_alpha,
                          ignore_index=cfg.ignore_index)
            if cfg.aux_cam2seg:
                sl_aux = seg_loss(seg_pred, refine_mask_aux, fg_alpha=cfg.segfg_alpha,
                                  ignore_index=cfg.ignore_index)
                sl = (1 - cfg.aux_cam2seg_alpha) * sl + cfg.aux_cam2seg_alpha * sl_aux
            cl = camloss_fn(out["cam"], valid_seg_ps)
            if cfg.aux_seg2cam:
                cl_aux = camloss_fn(out["cam_aux"], valid_seg_ps)
                cl = (1 - cfg.aux_seg2cam_alpha) * cl + cfg.aux_seg2cam_alpha * cl_aux
        with record_function("energy"):
            reg = get_energy_loss(
                simg, seg_pred, refine_mask, img_box,
                weight=cfg.energy_weight,
                sigma_rgb=cfg.energy_sigma_rgb,
                sigma_xy=cfg.energy_sigma_xy,
                scale_factor=cfg.energy_scale,
                filter_kind=cfg.energy_filter,
                rff_features=cfg.energy_rff_features,
                ignore_index=cfg.ignore_index,
                half=mp,
                convention=energy_convention,
            )
        gate = cfg.warmup_gate_floor if state.step <= cfg.warmup_iters else 1.0
        total = cls_loss + cls_aux_loss + gate * (
            cfg.seg_weight * sl + cfg.cam_weight * cl + cfg.reg_weight * reg
        )

        with record_function("backward"):
            state.optimizer.zero_grad()
            total.backward()
        with record_function("optimizer"):
            state.optimizer.step(state.step)
        with record_function("ema"):
            ema_update(state.teacher, state.student, cfg.momentum)

        # the logged lr is schedule(step) before the increment: the
        # reference sets lr from global_step, then increments it
        lr = state.optimizer.lr_at(state.step)
        state.step += 1
        return dict(
            overall_loss=total.detach(),
            cls_loss=cls_loss.detach(),
            cls_aux_loss=cls_aux_loss.detach(),
            seg_loss=sl.detach(),
            cam_loss=cl.detach(),
            reg_loss=reg.detach(),
            cls_logits=out["cls"].detach(),
            cls_aux_logits=out["cls_aux"].detach(),
            lr=lr,
            thre_low=thre[0],
            thre_high=thre[1],
        )

    return train_step
