"""The plain CoSA co-training step and validation batch.

The step (CoSA main.py:106-252): the EMA teacher's multi-scale x flip TTA
on the weak image, CAM -> pseudo masks of both heads by the fixed
thresholds, the teacher's seg logits -> soft CAM targets, the student's
forward on the strong image, the cls, seg, CAM and dense-energy losses,
the backward, AdamW over CoSA's four parameter groups with the poly
warm-up schedule, and the EMA teacher update. The validation batch
(evaluation_engine.py): each image resized to the crop, the student's
multi-scale x flip TTA, the maps laid on the zero canvas at each image's
own size, and the CAM, aux-CAM, Seg_ps and Seg_vd confusion matrices.

Only the options the benchmark's configurations use are written out; a
configuration that asks for another raises here.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import ops
from benchmark.reference.model import Network

# what this reference computes; any other value of these keys raises
SUPPORTED = dict(usegmm=False, usepar=False, aux_cam2seg=True, aux_seg2cam=False,
                 camloss_version="v1", use_cammix=False, detach="none", after_softmax=False,
                 decoder="LargeFOV", energy_filter="rff", isgap=False, optimizer="poly_adamw",
                 freeze_norm=False)
BETAS, EPS = (0.9, 0.999), 1e-8
# faults that the check has to catch, planted here in the program's place:
# the losses taken over the first half of the batch (the forward whole), and
# each update applied in the opposite direction
FAULTS = ("", "half_loss", "flipped_update")


def check_supported(c: Dict) -> None:
    wrong = {k: c.get(k) for k, v in SUPPORTED.items() if c.get(k, v) != v}
    if wrong:
        raise NotImplementedError(f"the plain reference does not compute {wrong}")


def multi_scale_camseg(net, w, imgs, scales, getcls=False):
    """Teacher TTA fuse (seg_helper.py:232-275): CAMs max over the flip, ReLU
    sum over scales, min-max normalized; seg logits summed; cam_aux is the
    last scale's flip max."""
    b, h, w_, _ = imgs.shape
    cam_sum = seg_sum = cls_sum = cls_aux_sum = 0.0
    cam_aux = None
    for i, s in enumerate(scales):
        if s == 1.0:
            x = torch.cat([imgs, ops.hflip(imgs)])
        else:
            sz = ops.scale_size(h, w_, s)
            x = torch.cat([ops.resize_bilinear(imgs, sz), ops.resize_bilinear(imgs, sz, True)])
        out = net(x, w)

        def fuse(m, op):
            return op(ops.resize_bilinear(m[:b], (h, w_)),
                      ops.resize_bilinear(m[b:], (h, w_), flip_w=True))

        cam_sum = cam_sum + F.relu(fuse(out["cam"], torch.maximum))
        seg_sum = seg_sum + fuse(out["seg"], torch.add)
        if i == len(scales) - 1:
            cam_aux = F.relu(fuse(out["cam_aux"], torch.maximum))
        if getcls:
            cls_sum = cls_sum + out["cls"][:b] + out["cls"][b:]
            cls_aux_sum = cls_aux_sum + out["cls_aux"][:b] + out["cls_aux"][b:]
    res = (ops.minmax_norm(cam_sum), ops.minmax_norm(cam_aux), seg_sum)
    return res + (cls_sum, cls_aux_sum) if getcls else res


def param_group(name: str) -> str:
    """CoSA's optimizer groups (main.py:57-72)."""
    if "pos_embed" in name:
        return "frozen"
    if name.startswith("encoder"):
        return "norm" if "norm" in name else "backbone"
    if "classifier" in name:
        return "head"
    if name.startswith("decoder"):
        return "decoder"
    return "backbone"


def poly_warmup_lr(base_lr: float, step: int, warmup: int, max_iter: int,
                   ratio: float = 1e-6, power: float = 0.9) -> float:
    """PolyWarmupAdamW's lr(step), evaluated in f32."""
    f = np.float32
    s = f(min(step, max_iter - 1))
    if s < warmup:
        mult = s / f(warmup) + (f(1.0) - s / f(warmup)) * f(ratio)
    else:
        mult = (f(1.0) - s / f(max_iter)) ** f(power)
    return float(f(base_lr) * mult)


class TrainStep:
    """The plain step over its own copies of the student's and the
    teacher's weights. ``step`` is the schedule's step counter at the
    first call."""

    def __init__(self, c: Dict, widths: Dict, student: Dict[str, torch.Tensor],
                 teacher: Dict[str, torch.Tensor], step: int, precision: str = "f32",
                 fault: str = ""):
        check_supported(c)
        if fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        self.c, self.fault = c, fault
        self.first: Optional[Dict[str, torch.Tensor]] = None
        self.net = Network(widths, c["num_classes"], c["aux_layer"], precision)
        self.student = {k: v.detach().clone().to(torch.float32).requires_grad_(
            param_group(k) != "frozen") for k, v in student.items()}
        self.teacher = {k: v.detach().clone().to(torch.float32) for k, v in teacher.items()}
        self.step = step
        self.mult = dict(backbone=1.0, norm=1.0, head=c["lrscale"], decoder=c["lrscale"])
        groups = {g: [] for g in self.mult}
        for k, p in self.student.items():
            if param_group(k) != "frozen":
                groups[param_group(k)].append(p)
        self.groups = [g for g in self.mult if groups[g]]
        wd = dict(backbone=c["wt_dec"], norm=c["wt_dec"] * c["wt_dec_mult"],
                  head=c["wt_dec"], decoder=c["wt_dec"])
        self.opt = torch.optim.AdamW(
            [dict(params=groups[g], lr=0.0, weight_decay=wd[g]) for g in self.groups],
            betas=BETAS, eps=EPS, foreach=False, fused=False)

    def targets(self, wimg, cls_label, img_box) -> Dict[str, torch.Tensor]:
        """The teacher's TTA (``cam``, ``cam_aux``, ``seg``) and the student's
        targets from it: the pseudo masks of both heads and the soft CAM
        targets."""
        c = self.c
        with torch.no_grad():
            cam, cam_aux, seg = multi_scale_camseg(self.net, self.teacher, wimg,
                                                   c["pseudo_scales"])
            kw = dict(img_box=img_box, cls_labels=cls_label, downscale=c["par_downscale"],
                      ignore_index=c["ignore_index"])
            mask = ops.cam2mask(cams=ops.cam_validation(cam, cls_label),
                                threshold_high=c["high_thre"], threshold_low=c["low_thre"], **kw)
            mask_aux = ops.cam2mask(cams=ops.cam_validation(cam_aux, cls_label),
                                    threshold_high=c["high_thre_aux"],
                                    threshold_low=c["low_thre_aux"], **kw)
            soft = ops.seg_refine_by_label(seg, cls_label, c["seg_softmaxtemp"])
        return dict(cam=cam, cam_aux=cam_aux, seg=seg, mask=mask, mask_aux=mask_aux, soft=soft)

    def losses(self, simg, cls_label, img_box, targets) -> Dict[str, torch.Tensor]:
        c = self.c
        h, w = simg.shape[1:3]
        out = self.net(simg, self.student)
        self.logits = torch.cat([out["cls"], out["cls_aux"]], dim=1).detach()
        self.seg_logits = out["seg"].detach()
        if self.fault == "half_loss":
            n = simg.shape[0] // 2
            out, targets = ({k: v[:n] for k, v in d.items()} for d in (out, targets))
            simg, cls_label, img_box = simg[:n], cls_label[:n], img_box[:n]
        mask = targets["mask"]
        seg_pred = ops.resize_bilinear(out["seg"], (h, w))
        a = c["aux_cam2seg_alpha"]
        sl = ((1 - a) * ops.seg_loss(seg_pred, mask, c["segfg_alpha"], c["ignore_index"])
              + a * ops.seg_loss(seg_pred, targets["mask_aux"], c["segfg_alpha"],
                                 c["ignore_index"]))
        res = dict(cls_loss=ops.multilabel_soft_margin(out["cls"], cls_label),
                   cls_aux_loss=ops.multilabel_soft_margin(out["cls_aux"], cls_label),
                   seg_loss=sl, cam_loss=ops.cam_loss_v1(out["cam"], targets["soft"]),
                   reg_loss=ops.energy_loss(simg, seg_pred, mask, img_box, c,
                                            c["ignore_index"]))
        gate = c["warmup_gate_floor"] if self.step <= c["warmup_iters"] else 1.0
        res["overall_loss"] = res["cls_loss"] + res["cls_aux_loss"] + gate * (
            c["seg_weight"] * sl + c["cam_weight"] * res["cam_loss"]
            + c["reg_weight"] * res["reg_loss"])
        return res

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One step on a batch of uint8 images; returns its losses and leaves
        the student's gradients in ``.grad``, its image-level logits (both
        heads') in ``.logits`` and its seg logits in ``.seg_logits``. The
        first call also keeps its targets and seg logits in ``.first``."""
        c = self.c
        cls_label = batch["cls_label"].to(torch.float32)
        simg = ops.normalize(batch["simg"])
        targets = self.targets(ops.normalize(batch["wimg"]), cls_label, batch["img_box"])
        res = self.losses(simg, cls_label, batch["img_box"], targets)
        if self.first is None:
            self.first = dict(targets, seg_logits=self.seg_logits)
        self.opt.zero_grad(set_to_none=True)
        res["overall_loss"].backward()
        for g, group in zip(self.groups, self.opt.param_groups):
            group["lr"] = poly_warmup_lr(c["lr"] * self.mult[g], self.step,
                                         c["lr_warmup_iters"], c["max_iters"])
        before = {k: p.detach().clone() for k, p in self.student.items()} \
            if self.fault == "flipped_update" else {}
        self.opt.step()
        with torch.no_grad():
            for k, b in before.items():
                self.student[k].mul_(-1).add_(b, alpha=2.0)
            m = c["momentum"]
            for k, t in self.teacher.items():
                t.mul_(m).add_(self.student[k].detach(), alpha=1.0 - m)
        self.step += 1
        return {k: float(v.detach()) for k, v in res.items()}


def eval_batch(c: Dict, net: Network, w: Dict[str, torch.Tensor], samples: List[Dict],
               device) -> Dict[str, torch.Tensor]:
    """One validation batch: the stacked (4, n, n) confusion matrices (CAM,
    aux CAM, Seg_ps, Seg_vd) and the validated seg logits on the canvas."""
    n = c["num_classes"]
    sizes = [s["image"].shape[:2] for s in samples]
    pad = c["eval_canvas"]
    if max(max(hw) for hw in sizes) > pad:
        raise ValueError(f"an image is larger than the {pad} canvas")
    sz = (c["crop_size"], c["crop_size"])
    imgs = torch.cat([ops.resize_bilinear(ops.normalize(
        torch.from_numpy(s["image"]).to(device)[None]), sz) for s in samples])
    cls = torch.from_numpy(np.stack([s["cls_label"] for s in samples])).to(device, torch.float32)
    with torch.no_grad():
        cam, cam_aux, seg = multi_scale_camseg(net, w, imgs, c["eval_scales"])
        r_cam, r_aux, r_seg = (ops.canvas(x, sizes, pad) for x in (cam, cam_aux, seg))
        gt = torch.full((len(samples), pad, pad), 255, dtype=torch.int64, device=device)
        for i, (h, w_) in enumerate(sizes):
            gt[i, :h, :w_] = torch.from_numpy(samples[i]["label"].astype(np.int64)).to(device)
        seg_vd = ops.seg_validation(r_seg, cls)
        hists = torch.stack([
            ops.torch_hist(gt, ops.cam_to_label(r_cam, cls, c["bkg_thre"]), n),
            ops.torch_hist(gt, ops.cam_to_label(r_aux, cls, c["bkg_thre"]), n),
            ops.torch_hist(gt, torch.argmax(r_seg, dim=-1), n),
            ops.torch_hist(gt, torch.argmax(seg_vd, dim=-1), n)])
    return dict(hists=hists, seg_vd=seg_vd)
