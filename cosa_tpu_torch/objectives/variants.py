"""Unused TTA-fuse and seg-loss variants of the reference, kept working
(the JAX package's objectives/variants.py; reference utils/seg_helper.py
:277-513 and :815-861), NHWC like the rest of objectives/:

  * :func:`multi_scale_camseg_v2`  configurable flip-fuse / scale-fuse
    modes for CAM and seg (seg_helper.py:328-397);
  * :func:`multi_scale_camseg_v4`  global (whole-tensor) min-max CAM
    normalization after cam_validation (seg_helper.py:277-326);
  * :func:`multi_scale_seg` / :func:`multi_scale_cls`  seg-only / cls-only
    TTA sums (seg_helper.py:452-513);
  * :func:`seg_get_pseudo`         top-2-margin pseudo labels (:570-578);
  * :func:`seg_loss_v2`            plain masked CE (:815-821);
  * :func:`seg_weightloss`         per-pixel-weighted fg/bg CE (:823-835);
  * :func:`seg_softloss` / :func:`seg_softloss_v2`  soft-target CEs
    (:837-861);
  * :func:`mask_to_onehot`         (:124-140).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cosa_tpu_torch.kernels.tta_fuse import minmax_norm
from cosa_tpu_torch.objectives.losses import _per_pixel_nll
from cosa_tpu_torch.objectives.pseudo import cam_validation, scale_size
from cosa_tpu_torch.ops.image import hflip
from cosa_tpu_torch.ops.resize import resize_bilinear

Forward = Callable[[torch.Tensor], Dict[str, torch.Tensor]]


def _tta_batches(imgs: torch.Tensor, scales: Sequence[float]) -> Iterator[torch.Tensor]:
    """The (2B, h', w', 3) batch of each scale: the images, then their flips."""
    h, w = imgs.shape[1:3]
    assert 1.0 in tuple(scales), "scale 1.0 must be in scales"
    for s in scales:
        if s == 1.0:
            yield torch.cat([imgs, hflip(imgs)], dim=0)
        else:
            sz = scale_size(h, w, s)
            yield torch.cat([resize_bilinear(imgs, sz),
                             resize_bilinear(imgs, sz, flip_w=True)], dim=0)


def _flip_fuse(x: torch.Tensor, b: int, hw: Tuple[int, int], mode: str) -> torch.Tensor:
    a = resize_bilinear(x[:b].to(torch.float32), hw)
    f = resize_bilinear(x[b:].to(torch.float32), hw, flip_w=True)
    return torch.maximum(a, f) if mode == "max" else a + f


def _scale_fuse(parts, mode: str) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p) if mode == "max" else out + p
    return out


def multi_scale_camseg_v2(forward: Forward, imgs: torch.Tensor, scales: Sequence[float],
                          cam_fuse: Tuple[str, str] = ("max", "sum"),
                          seg_fuse: Tuple[str, str] = ("max", "sum")):
    """Configurable-fuse TTA (seg_helper.py:328-397), in f32. Quirks kept:
    cam_aux keeps only the last scale and is flip-fused alone; CAM and aux
    end with per-channel min-max normalization."""
    b, h, w = imgs.shape[:3]
    cams, segs, aux_last = [], [], None
    for xcat in _tta_batches(imgs, scales):
        out = forward(xcat)
        cams.append(F.relu(_flip_fuse(out["cam"], b, (h, w), cam_fuse[0])))
        aux_last = F.relu(_flip_fuse(out["cam_aux"], b, (h, w), cam_fuse[0]))
        segs.append(_flip_fuse(out["seg"], b, (h, w), seg_fuse[0]))
    cam = minmax_norm(_scale_fuse(cams, cam_fuse[1]), eps=1e-5)
    cam_aux = minmax_norm(aux_last, eps=1e-5)
    return cam, cam_aux, _scale_fuse(segs, seg_fuse[1])


def _global_norm(x: torch.Tensor) -> torch.Tensor:
    x = x - x.min()
    return x / (x.max() + 1e-5)


def multi_scale_camseg_v4(forward: Forward, imgs: torch.Tensor, scales: Sequence[float],
                          cls_label: torch.Tensor):
    """Global-min-max TTA (seg_helper.py:277-326): fuse like the live TTA,
    apply cam_validation, then normalize by the min and max over the whole
    tensor (batch, channels and space at once)."""
    b, h, w = imgs.shape[:3]
    cam_sum, aux_last, seg_sum = 0.0, None, 0.0
    for xcat in _tta_batches(imgs, scales):
        out = forward(xcat)
        cam_sum = cam_sum + F.relu(_flip_fuse(out["cam"], b, (h, w), "max"))
        aux_last = F.relu(_flip_fuse(out["cam_aux"], b, (h, w), "max"))
        seg_sum = seg_sum + _flip_fuse(out["seg"], b, (h, w), "sum")
    cam = _global_norm(cam_validation(cam_sum, cls_label))
    cam_aux = _global_norm(cam_validation(aux_last, cls_label))
    return cam, cam_aux, seg_sum


def multi_scale_seg(forward_seg: Callable[[torch.Tensor], torch.Tensor], imgs: torch.Tensor,
                    scales: Sequence[float]) -> torch.Tensor:
    """Seg-only sum-fused TTA (seg_helper.py:452-490)."""
    b, h, w = imgs.shape[:3]
    seg_sum = 0.0
    for xcat in _tta_batches(imgs, scales):
        seg_sum = seg_sum + _flip_fuse(forward_seg(xcat), b, (h, w), "sum")
    return seg_sum


def multi_scale_cls(forward_cls: Callable[[torch.Tensor], torch.Tensor], imgs: torch.Tensor,
                    scales: Sequence[float]) -> torch.Tensor:
    """Cls-only TTA (seg_helper.py:492-513): image and flip logits summed
    over every scale."""
    b = imgs.shape[0]
    cls_sum = 0.0
    for xcat in _tta_batches(imgs, scales):
        logits = forward_cls(xcat).to(torch.float32)
        cls_sum = cls_sum + logits[:b] + logits[b:]
    return cls_sum


def seg_get_pseudo(seg: torch.Tensor, greater: float = 1.5,
                   ignore_index: int = 255) -> torch.Tensor:
    """Top-2-margin pseudo labels (seg_helper.py:570-578): the argmax where
    the top probability beats ``greater`` x the runner-up, else ignore.
    seg (B, H, W, C) logits -> (B, H, W) int32."""
    prob = torch.softmax(seg.to(torch.float32), dim=-1)
    top1, lab = prob.max(dim=-1)
    top2 = prob.scatter(-1, lab[..., None], float("-inf")).amax(dim=-1)
    lab = lab.to(torch.int32)
    return torch.where(top1 < greater * top2, torch.full_like(lab, ignore_index), lab)


def seg_loss_v2(seg_pred: torch.Tensor, mask_label: torch.Tensor,
                ignore_index: int = 255) -> torch.Tensor:
    """Plain masked CE, sum over the valid count (seg_helper.py:815-821)."""
    valid = mask_label != ignore_index
    nll = _per_pixel_nll(seg_pred, mask_label)
    return torch.where(valid, nll, 0.0).sum() / (valid.sum() + 1e-6)


def seg_weightloss(seg_pred: torch.Tensor, mask_label: torch.Tensor,
                   mask_weights: torch.Tensor, fg_alpha: float = 0.5,
                   ignore_index: int = 255) -> torch.Tensor:
    """Per-pixel-weighted fg/bg CE (seg_helper.py:823-835): each term is the
    weighted nll sum over the unweighted valid count."""
    wnll = _per_pixel_nll(seg_pred, mask_label) * mask_weights.to(torch.float32)
    bg_mask = mask_label == 0
    fg_mask = (mask_label != 0) & (mask_label != ignore_index)
    bg = torch.where(bg_mask, wnll, 0.0).sum() / (bg_mask.sum() + 1e-6)
    fg = torch.where(fg_mask, wnll, 0.0).sum() / (fg_mask.sum() + 1e-6)
    return (1.0 - fg_alpha) * bg + fg_alpha * fg


def seg_softloss_v2(seg_pred: torch.Tensor, softprobs: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft-target CE, the mean over pixels (seg_helper.py:855-861), or over
    the pixels of ``mask``."""
    ce = (-F.log_softmax(seg_pred.to(torch.float32), dim=-1) * softprobs).sum(dim=-1)
    if mask is None:
        return ce.mean()
    m = mask.to(torch.float32)
    return (ce * m).sum() / (m.sum() + 1e-6)


def seg_softloss(seg_pred: torch.Tensor, softprobs: torch.Tensor,
                 fg_alpha: float = 0.5) -> torch.Tensor:
    """fg/bg-separated soft CE (seg_helper.py:837-853): pixels split by the
    soft target's argmax (0 = background)."""
    labels = torch.argmax(softprobs, dim=-1)
    bg = seg_softloss_v2(seg_pred, softprobs, labels == 0)
    fg = seg_softloss_v2(seg_pred, softprobs, labels != 0)
    return (1.0 - fg_alpha) * bg + fg_alpha * fg


def mask_to_onehot(mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, H, W) int mask -> (B, H, W, C) f32 one-hot (seg_helper.py:124-140);
    a value outside [0, C) gives a zero row."""
    assert num_classes > 0
    classes = torch.arange(num_classes, device=mask.device)
    return (mask.to(torch.int64)[..., None] == classes).to(torch.float32)
