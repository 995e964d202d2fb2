"""Plain tensor operations of the CoSA step and its evaluation, NHWC.

A frozen copy of the program's plain arithmetic (image normalization,
torch-parity resizes, the pseudo-label and loss functions), in float32,
importing nothing of the program. The benchmark's plain reference is built
from these; the program may change its own versions freely.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
NEG_INF = -1e5  # CoSA's logit for a class absent from the image (seg_helper.py:565)


def normalize(img_u8: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img_u8.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img_u8.device)
    return (img_u8.to(torch.float32) - mean) / std


def denormalize_u8(img: torch.Tensor) -> torch.Tensor:
    """Normalized image -> 0-255 with CoSA's uint8 truncation."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    return torch.clamp(img * std + mean, 0, 255).to(torch.uint8).to(torch.float32)


def hflip(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(-2,))


def _interp(x: torch.Tensor, size, mode: str) -> torch.Tensor:
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.to(torch.float32).permute(0, 3, 1, 2), size=tuple(size), mode=mode,
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def resize_bilinear(x: torch.Tensor, size, flip_w: bool = False) -> torch.Tensor:
    y = _interp(x, size, "bilinear")
    return hflip(y) if flip_w else y


def resize_bicubic(x: torch.Tensor, size) -> torch.Tensor:
    return _interp(x, size, "bicubic")


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """torch's legacy 'nearest' as an index gather (labels keep their values)."""
    h, w = x.shape[1], x.shape[2]
    if (h, w) == tuple(size):
        return x

    def index(n_in, n_out):
        dst = np.arange(n_out, dtype=np.float64)
        idx = np.minimum(np.floor(dst * (n_in / n_out)), n_in - 1).astype(np.int64)
        return torch.from_numpy(idx).to(x.device)

    return x.index_select(1, index(h, size[0])).index_select(2, index(w, size[1]))


def box_mask(img_box: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 4) [h0, h1, w0, w1] (slice semantics) -> (B, h, w) bool."""
    box = img_box.to(torch.int64)
    ends = [torch.where(box[:, i] < 0, box[:, i] + n, box[:, i])[:, None, None]
            for i, n in enumerate((h, h, w, w))]
    iy = torch.arange(h, device=box.device)[None, :, None]
    ix = torch.arange(w, device=box.device)[None, None, :]
    return (iy >= ends[0]) & (iy < ends[1]) & (ix >= ends[2]) & (ix < ends[3])


def minmax_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = (x - mn).amax(dim=(1, 2), keepdim=True)
    return (x - mn) / (mx + eps)


def with_bkg(cls_label: torch.Tensor) -> torch.Tensor:
    ones = torch.ones((cls_label.shape[0], 1), dtype=cls_label.dtype, device=cls_label.device)
    return torch.cat([ones, cls_label], dim=1)


def cam_validation(cam: torch.Tensor, cls_label: torch.Tensor) -> torch.Tensor:
    return cam * cls_label.to(cam.dtype)[:, None, None, :]


def seg_validation(seg: torch.Tensor, cls_label: torch.Tensor) -> torch.Tensor:
    lab = with_bkg(cls_label)[:, None, None, :]
    return torch.where(lab == 0, torch.full_like(seg, NEG_INF), seg)


def seg_refine_by_label(seg: torch.Tensor, cls_label: torch.Tensor,
                        softmaxtemp: float) -> torch.Tensor:
    """Teacher seg logits -> soft targets of the CAM loss (seg_helper.py:553-568)."""
    return torch.softmax(seg_validation(seg.to(torch.float32), cls_label) / softmaxtemp, dim=-1)


def cam_to_label(cam: torch.Tensor, cls_label: torch.Tensor, bkg_thre: float) -> torch.Tensor:
    """Argmax CAM -> label (+1 offset), background where the max <= bkg_thre."""
    valid = cam_validation(cam, cls_label)
    label = torch.argmax(valid, dim=-1) + 1
    return torch.where(valid.amax(dim=-1) <= bkg_thre, torch.zeros_like(label), label)


def _threshold_argmax(cams_bkg, lab_bk, down, orig) -> torch.Tensor:
    x = resize_bilinear(cams_bkg, down) if down != orig else cams_bkg
    x = torch.where(lab_bk[:, None, None, :] == 0, torch.full_like(x, NEG_INF), x)
    probs = torch.softmax(x.to(torch.float32), dim=-1)
    return torch.argmax(resize_bilinear(probs, orig), dim=-1)


def cam2mask(img_box, cams, cls_labels, threshold_high, threshold_low, downscale: int,
             ignore_index: int) -> torch.Tensor:
    """CAM -> hard pseudo mask (seg_helper.py:721-797): high-threshold label;
    ignore where it says background; background where both thresholds do;
    ignore outside the crop box."""
    b, h, w, _ = cams.shape
    ones = torch.ones((b, h, w, 1), dtype=cams.dtype, device=cams.device)
    lab_bk = with_bkg(cls_labels)
    down = (h // downscale, w // downscale) if downscale else (h, w)
    hi = _threshold_argmax(torch.cat([ones * threshold_high, cams], -1), lab_bk, down, (h, w))
    lo = _threshold_argmax(torch.cat([ones * threshold_low, cams], -1), lab_bk, down, (h, w))
    label = torch.where(hi == 0, torch.full_like(hi, ignore_index), hi)
    label = torch.where(hi + lo == 0, torch.zeros_like(hi), label)
    return torch.where(box_mask(img_box, h, w), label, torch.full_like(hi, ignore_index))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def multilabel_soft_margin(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    y = targets.to(torch.float32)
    per = y * softplus(-logits) + (1.0 - y) * softplus(logits)
    return per.mean(dim=-1).mean()


def seg_loss(seg_pred, mask, fg_alpha: float, ignore_index: int) -> torch.Tensor:
    """fg/bg-separated masked cross-entropy (seg_helper.py:800-813)."""
    logp = F.log_softmax(seg_pred.to(torch.float32), dim=-1)
    idx = mask.to(torch.int64).clamp(0, seg_pred.shape[-1] - 1)
    nll = -logp.gather(-1, idx[..., None])[..., 0]
    bg = mask == 0
    fg = (mask != 0) & (mask != ignore_index)
    zero = torch.zeros_like(nll)
    bg_l = torch.where(bg, nll, zero).sum() / (bg.sum() + 1e-6)
    fg_l = torch.where(fg, nll, zero).sum() / (fg.sum() + 1e-6)
    return (1.0 - fg_alpha) * bg_l + fg_alpha * fg_l


def cam_loss_v1(cam: torch.Tensor, seg_ps: torch.Tensor) -> torch.Tensor:
    """Multilabel soft margin between ReLU(CAM) and the teacher's soft
    foreground assignments resized to the CAM grid."""
    fg = resize_bilinear(seg_ps[..., 1:], tuple(cam.shape[1:3]))
    return multilabel_soft_margin(F.relu(cam), fg)


def torch_hist(gt: torch.Tensor, pred: torch.Tensor, n: int) -> torch.Tensor:
    """(n, n) confusion matrix; gt outside [0, n) drops the pixel, predictions
    clip to [0, n - 1]."""
    gt = gt.reshape(-1).to(torch.int64)
    pred = pred.reshape(-1).to(torch.int64).clamp(0, n - 1)
    keep = (gt >= 0) & (gt < n)
    return torch.bincount(gt[keep] * n + pred[keep], minlength=n * n).reshape(n, n)


def scale_size(h: int, w: int, s: float) -> Tuple[int, int]:
    return int(s * h), int(s * w)


def canvas(maps: torch.Tensor, sizes, pad: int) -> torch.Tensor:
    """(B, s, s, C) -> (B, pad, pad, C): each image's maps resized to its own
    (h, w) at the top left, zero elsewhere."""
    out = maps.new_zeros((maps.shape[0], pad, pad, maps.shape[-1]))
    for i, (h, w) in enumerate(sizes):
        out[i, :h, :w] = resize_bilinear(maps[i:i + 1], (h, w))[0]
    return out


def rff_params(n_features: int, dim: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Orthogonal random Fourier features (Yu et al., 2016) drawn from
    ``seed``: the frequencies and phases of CoSA's RFF energy filter."""
    rng = np.random.default_rng(seed)
    blocks, remaining = [], n_features
    while remaining > 0:
        q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
        norms = np.linalg.norm(rng.standard_normal((dim, dim)), axis=1)
        blocks.append(q * norms[None, :])
        remaining -= dim
    w = np.concatenate(blocks, axis=1)[:, :n_features].astype(np.float32)
    b = rng.uniform(0.0, 2.0 * np.pi, size=(n_features,)).astype(np.float32)
    return w, b


def pixel_features(image: torch.Tensor, sigma_rgb: float, sigma_xy: float) -> torch.Tensor:
    """(B, H, W, 3) 0-255 -> (B, H, W, 5) bilateral features (x, y, r, g, b)."""
    b, h, w, _ = image.shape
    ys = torch.arange(h, dtype=torch.float32, device=image.device)[None, :, None, None]
    xs = torch.arange(w, dtype=torch.float32, device=image.device)[None, None, :, None]
    return torch.cat([xs.expand(b, h, w, 1) / sigma_xy, ys.expand(b, h, w, 1) / sigma_xy,
                      image.to(torch.float32) / sigma_rgb], dim=-1)


def rff_filter(feats: torch.Tensor, values: torch.Tensor, n_features: int,
               seed: int = 0) -> torch.Tensor:
    """G @ values with G ~= Phi Phi^T, Phi = sqrt(2/D) cos(f W + b), in f32."""
    w_np, b_np = rff_params(n_features, feats.shape[-1], seed)
    w = torch.from_numpy(w_np).to(feats.device)
    b = torch.from_numpy(b_np).to(feats.device)
    phi = float(np.sqrt(2.0 / n_features)) * torch.cos(feats @ w + b)
    return phi @ (phi.transpose(1, 2) @ values)


class DenseEnergy(torch.autograd.Function):
    """-<seg_roi, G(seg_roi) * gate> / B with CoSA's gradient convention
    -2 g AS_gated / B (seg_helper.py:191-230)."""

    @staticmethod
    def forward(ctx, seg_roi, gate, feats, n_features, convention):
        b, h, w, k = seg_roi.shape
        filt = rff_filter(feats, seg_roi.reshape(b, h * w, k), n_features)
        as_gated = convention * filt.reshape(b, h, w, k) * gate
        ctx.save_for_backward(as_gated)
        ctx.n = b
        return -(seg_roi * as_gated).sum() / b

    @staticmethod
    def backward(ctx, g):
        (as_gated,) = ctx.saved_tensors
        return -2.0 * g * as_gated / ctx.n, None, None, None, None


def energy_loss(img, seg_logits, label, img_box, c, ignore_index: int) -> torch.Tensor:
    """CoSA's dense-energy regularizer with the RFF filter; ``c`` holds the
    configuration's energy_* keys."""
    b, h, w, _ = img.shape
    probs = torch.softmax(seg_logits.to(torch.float32), dim=-1)
    rois = box_mask(img_box, h, w).to(torch.float32)
    sh, sw = int(h * c["energy_scale"]), int(w * c["energy_scale"])
    s_img = resize_nearest(denormalize_u8(img), (sh, sw))
    s_probs = resize_bilinear(probs, (sh, sw))
    s_rois = resize_nearest(rois, (sh, sw))
    s_label = resize_nearest(label, (sh, sw))
    gate = torch.clamp(s_rois - s_probs.amax(dim=-1), min=0.0)
    gate = torch.where(s_label == ignore_index, torch.ones_like(gate), gate)[..., None].detach()
    seg_roi = s_probs * s_rois[..., None]
    feats = pixel_features(s_img, c["energy_sigma_rgb"],
                           c["energy_sigma_xy"] * c["energy_scale"]).reshape(b, sh * sw, -1)
    return c["energy_weight"] * DenseEnergy.apply(
        seg_roi, gate, feats, c["energy_rff_features"], float(c["energy_convention"]))
