"""The co-training step (the JAX package's train/step.py::build_train_step,
itself covering the reference's main.py:106-252):

  teacher multi-scale TTA  (weak image, no grad)
  CAM -> pseudo mask       (batched cam2mask, main and aux heads)
  seg -> CAM soft targets
  student forward/backward (strong image): cls, seg, cam and energy losses
  PolyWarmupAdamW update
  EMA teacher update       (f32, every parameter)

Eager PyTorch updates the state in place: the step returns only its
metrics. Each phase runs under a ``torch.profiler.record_function`` span
(teacher_tta, pseudo_labels, student_forward, losses, energy, backward,
optimizer, ema), which ``torch.profiler`` reads and which cost next to
nothing without one. Loss weighting (main.py:240-243): the
cls losses are always on; seg/cam/reg are scaled by ``warmup_gate_floor``
while step <= warmup_iters.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import torch
from torch.profiler import record_function

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
from cosa_tpu_torch.ops.image import normalize
from cosa_tpu_torch.ops.resize import resize_bilinear
from cosa_tpu_torch.train.state import TrainState, ema_update


def build_train_step(cfg) -> Callable[[TrainState, Dict[str, torch.Tensor]], Dict]:
    if cfg.usegmm or cfg.usegmmaux:
        raise NotImplementedError("usegmm: GMM thresholds are ROADMAP Queue 1 item 11")
    if cfg.usepar:
        raise NotImplementedError("usepar: PAR refinement is ROADMAP Queue 1 item 12")
    if cfg.model != "vit":
        raise NotImplementedError(f"model '{cfg.model}' (ROADMAP Queue 1 item 19)")
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
            with record_function("pseudo_labels"):
                cam_src = (cam_ps + cam_aux_ps) / 2 if cfg.use_cammix else cam_ps
                mask_kwargs = dict(img_box=img_box, cls_labels=cls_label,
                                   downscale=cfg.par_downscale,
                                   ignore_index=cfg.ignore_index)
                refine_mask = cam2mask(
                    cams=cam_validation(cam_src, cls_label),
                    threshold_high=state.thre_high, threshold_low=state.thre_low,
                    **mask_kwargs)
                if cfg.aux_cam2seg:
                    refine_mask_aux = cam2mask(
                        cams=cam_validation(cam_aux_ps, cls_label),
                        threshold_high=cfg.high_thre_aux,
                        threshold_low=cfg.low_thre_aux, **mask_kwargs)
                valid_seg_ps = seg_refine_by_label(
                    seg_ps, cls_label, softmaxtemp=cfg.seg_softmaxtemp,
                    after_softmax=cfg.after_softmax,
                )

        # ---- student loss ------------------------------------------------
        with record_function("student_forward"):
            out = state.student(simg, detach=cfg.detach)
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
            thre_low=state.thre_low,
            thre_high=state.thre_high,
        )

    return train_step
