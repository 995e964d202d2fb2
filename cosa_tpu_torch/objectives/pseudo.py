"""Pseudo-label generation ops, batched on the device (NHWC).

Port of the JAX package's objectives/pseudo.py (twins of the reference's
utils/seg_helper.py algorithms):

  * :func:`multi_scale_camseg` — teacher multi-scale + flip TTA fuse;
  * :func:`cam2mask` — CAM -> hard pseudo mask via high/low background
    thresholds, with absent classes masked before a full-channel softmax
    (equal to the reference's per-image present-class subset);
  * :func:`cam_to_label`, :func:`cam_validation`, :func:`seg_validation`,
    :func:`seg_refine_by_label`.

img_box convention: (B, 4) int rows [h0, h1, w0, w1]; negative ends follow
Python-slice semantics.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from cosa_tpu_torch.kernels.tta_fuse import tta_fuse
from cosa_tpu_torch.ops.image import hflip
from cosa_tpu_torch.ops.resize import resize_bilinear
from cosa_tpu_torch.utils.trace import span

NEG_INF = -1e5  # reference uses -1e5 for invalid-class logits (seg_helper.py:565)


def box_mask(img_box: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B,4) [h0,h1,w0,w1] -> (B,h,w) bool inside-box mask (slice semantics)."""
    box = img_box.to(torch.int64)
    h0, h1, w0, w1 = box[:, 0], box[:, 1], box[:, 2], box[:, 3]
    h0 = torch.where(h0 < 0, h0 + h, h0)[:, None, None]
    h1 = torch.where(h1 < 0, h1 + h, h1)[:, None, None]
    w0 = torch.where(w0 < 0, w0 + w, w0)[:, None, None]
    w1 = torch.where(w1 < 0, w1 + w, w1)[:, None, None]
    iy = torch.arange(h, device=box.device)[None, :, None]
    ix = torch.arange(w, device=box.device)[None, None, :]
    return (iy >= h0) & (iy < h1) & (ix >= w0) & (ix < w1)


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


def _with_bkg(cls_label: torch.Tensor) -> torch.Tensor:
    ones = torch.ones((cls_label.shape[0], 1), dtype=cls_label.dtype,
                      device=cls_label.device)
    return torch.cat([ones, cls_label], dim=1)


def seg_validation(seg: torch.Tensor, cls_label: Optional[torch.Tensor]) -> torch.Tensor:
    """Set the seg logits of absent classes to -1e5; background is always
    valid (seg_helper.py:581-591). seg: (B,H,W,C), cls_label: (B,C-1)."""
    if cls_label is None:
        return seg
    lab_bk = _with_bkg(cls_label)[:, None, None, :]
    return torch.where(lab_bk == 0, torch.full_like(seg, NEG_INF), seg)


def seg_refine_by_label(
    seg: torch.Tensor,
    cls_label: torch.Tensor,
    softmaxtemp: float,
    after_softmax: bool = False,
) -> torch.Tensor:
    """Teacher seg logits -> soft pseudo-assignment for the CAM loss
    (seg_helper.py:553-568). seg: (B,H,W,C) raw logits."""
    lab_bk = _with_bkg(cls_label).to(torch.float32)[:, None, None, :]
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


def _threshold_argmax(cams_with_bkg, lab_bk, down, orig, refine_fn=None,
                      images_down=None) -> torch.Tensor:
    """softmax over present channels at low res -> (refine) -> upsample -> argmax."""
    x = resize_bilinear(cams_with_bkg, down) if down != orig else cams_with_bkg
    x = torch.where(lab_bk[:, None, None, :] == 0,
                    torch.full_like(x, NEG_INF), x)
    probs = torch.softmax(x.to(torch.float32), dim=-1)
    if refine_fn is not None:
        probs = refine_fn(images_down, probs)
    probs = resize_bilinear(probs, orig)
    return torch.argmax(probs, dim=-1).to(torch.int32)


def cam2mask(
    img_box: torch.Tensor,
    cams: torch.Tensor,
    cls_labels: torch.Tensor,
    threshold_high,
    threshold_low,
    downscale: int = 2,
    ignore_index: int = 255,
    refine_fn: Optional[Callable] = None,
    images: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CAM -> hard pseudo mask (reference seg_helper.py:721-797), batched.

    cams: (B,H,W,C-1) validated CAMs; the thresholds are floats or 0-d
    tensors (the GMM's EMAs). ``refine_fn(images_down, probs)`` is the
    optional PAR pass on the (B,h,w,C) probabilities at the downscaled
    resolution; it needs ``images`` (B,H,W,3, denormalized to 0-1). Merge
    rule: start from the high-threshold label; where high says bkg ->
    ignore; where both say bkg -> bkg; outside the img_box -> ignore."""
    b, h, w, _ = cams.shape
    ones = torch.ones((b, h, w, 1), dtype=cams.dtype, device=cams.device)
    lab_bk = _with_bkg(cls_labels)
    down = (h // downscale, w // downscale) if downscale else (h, w)
    images_down = None
    if refine_fn is not None:
        if images is None:
            raise ValueError("cam2mask with refine_fn needs images")
        images_down = resize_bilinear(images, down) if down != (h, w) else images
    hi = _threshold_argmax(torch.cat([ones * threshold_high, cams], dim=-1), lab_bk,
                           down, (h, w), refine_fn, images_down)
    lo = _threshold_argmax(torch.cat([ones * threshold_low, cams], dim=-1), lab_bk,
                           down, (h, w), refine_fn, images_down)
    ign = torch.full_like(hi, ignore_index)
    label = torch.where(hi == 0, ign, hi)
    label = torch.where((hi + lo) == 0, torch.zeros_like(hi), label)
    inside = box_mask(img_box, h, w)
    return torch.where(inside, label, ign)
