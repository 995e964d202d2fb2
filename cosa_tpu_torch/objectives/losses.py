"""Training losses (NHWC), port of the JAX package's objectives/losses.py:

  * multilabel soft-margin (torch's multilabel_soft_margin_loss, written
    with an exact softplus so it equals the JAX form);
  * the per-pixel masked cross-entropy ``cross_entropy_ignore``;
  * fg/bg-separated masked cross-entropy ``seg_loss``
    (utils/seg_helper.py:800-813);
  * CAM losses v1/v2/v3 (utils/seg_helper.py:593-653).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from cosa_tpu_torch.ops.resize import resize_bilinear
from cosa_tpu_torch.parallel.tensor import all_reduce_sum_, group_size


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def multilabel_soft_margin(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-mean_i mean_c [ y log sigma(x) + (1-y) log sigma(-x) ]."""
    x = logits.to(torch.float32)
    y = targets.to(torch.float32)
    per = y * _softplus(-x) + (1.0 - y) * _softplus(x)
    return per.mean(dim=-1).mean()


def _per_pixel_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[label] per pixel; out-of-range labels (the
    ignore index) read class 0 and are masked by every caller."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    idx = labels.to(torch.int64).clamp(0, logits.shape[-1] - 1)
    return -logp.gather(-1, idx[..., None])[..., 0]


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = 255) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel CE with an ignore mask. logits (B, H, W, C), labels
    (B, H, W). Returns (the CE summed over valid pixels, their count)."""
    valid = labels != ignore_index
    nll = torch.where(valid, _per_pixel_nll(logits, labels), 0.0)
    return nll.sum(), valid.sum()


def seg_loss(
    seg_pred: torch.Tensor,
    mask_label: torch.Tensor,
    fg_alpha: float = 0.5,
    ignore_index: int = 255,
    group=None,
) -> torch.Tensor:
    """fg/bg-separated masked CE (reference utils/seg_helper.py:800-813):
    each term sum-normalized by its own pixel count + 1e-6.

    The counts couple the samples, so under data parallelism (``group``,
    the data group) they are summed over the group's ranks, and the local
    sums over the global counts are scaled by the group size: the
    gradient averaged over the group, and the value averaged over it, are
    then the global batch's ``global_sum / (global_count + 1e-6)``."""
    nll = _per_pixel_nll(seg_pred, mask_label)
    bg_mask = mask_label == 0
    fg_mask = (mask_label != 0) & (mask_label != ignore_index)
    zero = torch.zeros_like(nll)
    counts = all_reduce_sum_(torch.stack([bg_mask.sum(), fg_mask.sum()]), group)
    scale = group_size(group)
    bg = torch.where(bg_mask, nll, zero).sum() * scale / (counts[0] + 1e-6)
    fg = torch.where(fg_mask, nll, zero).sum() * scale / (counts[1] + 1e-6)
    return (1.0 - fg_alpha) * bg + fg_alpha * fg


def _normalized_cam(cam: torch.Tensor, detach: bool = False) -> torch.Tensor:
    """ReLU + per-(sample, channel) spatial min-max normalization
    (reference cam_lossv2, utils/seg_helper.py:604-617)."""
    cam = F.relu(cam)
    d1 = cam.amin(dim=(1, 2), keepdim=True)
    d2 = cam.amax(dim=(1, 2), keepdim=True) + 1e-4
    if detach:
        d1, d2 = d1.detach(), d2.detach()
    return (cam - d1) / d2


def cam_loss_v1(cam: torch.Tensor, seg_ps: torch.Tensor, is_relu: bool = True) -> torch.Tensor:
    """Pixel-level multilabel soft-margin between ReLU(CAM) and the
    teacher's soft fg assignments. cam: (B,h,w,C-1); seg_ps: (B,H,W,C)."""
    h, w = cam.shape[1:3]
    fg = resize_bilinear(seg_ps[..., 1:], (h, w))
    if is_relu:
        cam = F.relu(cam)
    return multilabel_soft_margin(cam, fg)


def cam_loss_v2(cam: torch.Tensor, seg_ps: torch.Tensor, detach: bool = False) -> torch.Tensor:
    """v1 + min-max CAM normalization (utils/seg_helper.py:604-624)."""
    h, w = cam.shape[1:3]
    fg = resize_bilinear(seg_ps[..., 1:], (h, w))
    return multilabel_soft_margin(_normalized_cam(cam, detach), fg)


def cam_loss_v3(
    cam: torch.Tensor,
    seg_ps: torch.Tensor,
    seg_confident_thre: float = 0.25,
    detach: bool = False,
    cambgmax: bool = True,
    fg_alpha: float = 0.5,
    ignore_index: int = 255,
    group=None,
) -> torch.Tensor:
    """Hard-label CE variant (utils/seg_helper.py:626-653); ``group`` as
    :func:`seg_loss` takes it."""
    val = seg_ps.amax(dim=-1)
    lab = torch.argmax(seg_ps, dim=-1)
    lab = torch.where(val <= seg_confident_thre, torch.full_like(lab, ignore_index), lab)
    ncam = _normalized_cam(cam, detach)
    bg = (1.0 - ncam.amax(dim=-1, keepdim=True) if cambgmax
          else 1.0 - ncam.mean(dim=-1, keepdim=True))
    mix = resize_bilinear(torch.cat([bg, ncam], dim=-1), tuple(lab.shape[1:3]))
    return seg_loss(mix, lab, fg_alpha=fg_alpha, ignore_index=ignore_index, group=group)
