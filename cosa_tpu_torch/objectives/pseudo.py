"""Pseudo-label generation ops, batched on the device (NHWC).

Port of the JAX package's objectives/pseudo.py (twins of the reference's
utils/seg_helper.py algorithms):

  * :func:`multi_scale_camseg` — teacher multi-scale + flip TTA fuse;
  * :func:`cam2mask` — CAM -> hard pseudo mask via high/low background
    thresholds, with absent classes masked before a full-channel softmax
    (equal to the reference's per-image present-class subset): kernel K8's
    wrapper, ``kernels/cam2mask.py``, with :func:`box_mask`;
  * :func:`cam_to_label`, :func:`cam_validation`, :func:`seg_validation`,
    :func:`seg_refine_by_label`.

img_box convention: (B, 4) int rows [h0, h1, w0, w1]; negative ends follow
Python-slice semantics.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from cosa_tpu_torch.kernels.cam2mask import NEG_INF, box_mask, cam2mask, with_bkg  # noqa: F401
from cosa_tpu_torch.kernels.tta_fuse import tta_fuse
from cosa_tpu_torch.ops.image import hflip
from cosa_tpu_torch.ops.resize import resize_bilinear
from cosa_tpu_torch.utils.trace import span


def scale_size(h: int, w: int, s: float) -> Tuple[int, int]:
    return int(s * h), int(s * w)


def multi_scale_camseg(
    forward: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
    imgs: torch.Tensor,
    scales: Sequence[float],
    getcls: bool = False,
    cam_dtype=torch.float32,
):
    """Teacher TTA fuse (reference seg_helper.py:232-275).

    ``forward`` maps a (2B, h', w', 3) batch (images, then their flips) to
    the model output dict. CAMs fuse flip-wise by max, then scale-wise by
    ReLU-sum and min-max; seg logits sum in f32. Reference quirk kept:
    ``cam_aux`` is the LAST scale's flip-max only. CAM arithmetic runs in
    ``cam_dtype`` (bf16 under mixed precision). The fuse itself is one
    :func:`~cosa_tpu_torch.kernels.tta_fuse.tta_fuse` call over every
    scale's maps (at most 8 scales). Each scale's forward runs under the
    span ``tta_forward``, the rest under ``tta_fuse`` (``utils/trace.py``)."""
    b, h, w, _ = imgs.shape
    assert 1.0 in tuple(scales), "scale 1.0 must be in scales"
    cams, segs = [], []
    cls_sum = 0.0
    cls_aux_sum = 0.0
    for s in scales:
        with span("tta_fuse"):
            if s == 1.0:
                xcat = torch.cat([imgs, hflip(imgs)], dim=0)
            else:
                sz = scale_size(h, w, s)
                xcat = torch.cat(
                    [resize_bilinear(imgs, sz), resize_bilinear(imgs, sz, flip_w=True)],
                    dim=0,
                )
        with span("tta_forward"):
            out = forward(xcat)
        with span("tta_fuse"):
            cams.append(out["cam"])
            segs.append(out["seg"])
            if getcls:
                c = out["cls"].to(torch.float32)
                ca = out["cls_aux"].to(torch.float32)
                cls_sum = cls_sum + c[:b] + c[b:]
                cls_aux_sum = cls_aux_sum + ca[:b] + ca[b:]
    with span("tta_fuse"):
        cam, cam_aux, seg_sum = tta_fuse(cams, segs, out["cam_aux"], (h, w), cam_dtype)
    if getcls:
        return cam, cam_aux, seg_sum, cls_sum, cls_aux_sum
    return cam, cam_aux, seg_sum


def cam_validation(cam: torch.Tensor, cls_label: torch.Tensor) -> torch.Tensor:
    """Zero CAM channels absent from the image-level label.
    cam: (B,H,W,C-1), cls_label: (B,C-1)."""
    return cam * cls_label.to(cam.dtype)[:, None, None, :]


def seg_validation(seg: torch.Tensor, cls_label: Optional[torch.Tensor]) -> torch.Tensor:
    """Set the seg logits of absent classes to -1e5; background is always
    valid (seg_helper.py:581-591). seg: (B,H,W,C), cls_label: (B,C-1)."""
    if cls_label is None:
        return seg
    lab_bk = with_bkg(cls_label)[:, None, None, :]
    return torch.where(lab_bk == 0, torch.full_like(seg, NEG_INF), seg)


def seg_refine_by_label(
    seg: torch.Tensor,
    cls_label: torch.Tensor,
    softmaxtemp: float,
    after_softmax: bool = False,
) -> torch.Tensor:
    """Teacher seg logits -> soft pseudo-assignment for the CAM loss
    (seg_helper.py:553-568). seg: (B,H,W,C) raw logits."""
    lab_bk = with_bkg(cls_label).to(torch.float32)[:, None, None, :]
    if after_softmax:
        probs = torch.softmax(seg.to(torch.float32) / softmaxtemp, dim=-1)
        return lab_bk * probs
    masked = torch.where(lab_bk == 0, torch.full_like(seg, NEG_INF, dtype=torch.float32),
                         seg.to(torch.float32))
    return torch.softmax(masked / softmaxtemp, dim=-1)


def cam_to_label(
    cam: torch.Tensor,
    cls_label: Optional[torch.Tensor],
    img_box: Optional[torch.Tensor] = None,
    bkg_thre: float = 0.5,
    high_thre: Optional[float] = None,
    low_thre: Optional[float] = None,
    ignore_mid: bool = False,
    ignore_index: int = 255,
):
    """Argmax CAM -> label map (+1 class offset, bkg where max <= bkg_thre)
    (seg_helper.py:515-545). cam: (B,H,W,C-1). ``torch.argmax`` returns the
    first maximum, as ``jnp.argmax`` does."""
    valid_cam = cam if cls_label is None else cam_validation(cam, cls_label)
    cam_value = valid_cam.amax(dim=-1)
    label = torch.argmax(valid_cam, dim=-1).to(torch.int32) + 1
    zero = torch.zeros_like(label)
    label = torch.where(cam_value <= bkg_thre, zero, label)
    if img_box is None:
        return label
    ign = torch.full_like(label, ignore_index)
    if ignore_mid:
        label = torch.where(cam_value <= high_thre, ign, label)
        label = torch.where(cam_value <= low_thre, zero, label)
    inside = box_mask(img_box, cam.shape[1], cam.shape[2])
    return valid_cam, torch.where(inside, label, ign)
