"""Dense-energy (CRF) regularizer, on the device.

Port of the JAX package's objectives/energy.py, the twin of the
reference's ``DenseEnergyLoss`` (utils/seg_helper.py:191-230, 864-903):

  * seg logits -> softmax probs (full res);
  * images un-normalized to 0-255; crop ROI mask from img_box;
  * everything downscaled by ``scale_factor`` (images/ROIs/labels nearest,
    seg bilinear);
  * Gate = 1 on unlabeled (255) pixels else clip(ROI - max_prob, 0);
  * loss = -(1/B) sum seg_roi * (G @ seg_roi) * Gate, with sigma_xy scaled
    by scale_factor, and the reference's ad-hoc gradient
    dL/dseg_roi = -2 g AS_gated / B (a ``torch.autograd.Function``).

The filter G is the RFF surrogate (the default), the exact transform
(test-only) or the permutohedral lattice, the reference's own filter,
built from the same features once per call (once per train step).
"""

from __future__ import annotations

import numpy as np
import torch

from cosa_tpu_torch.objectives.pseudo import box_mask
from cosa_tpu_torch.ops.bilateral import (
    exact_gaussian_filter,
    pixel_features,
    rff_gaussian_filter,
)
from cosa_tpu_torch.ops.image import denormalize_u8
from cosa_tpu_torch.ops.permutohedral import apply_lattice, build_lattice
from cosa_tpu_torch.ops.resize import resize_bilinear, resize_nearest


def _filter_fn(feats, filter_kind, rff_features, rff_seed, half, convention):
    """The energy's Gaussian filter, (B, N, K) values -> (B, N, K)."""
    if filter_kind == "exact":
        return lambda v: exact_gaussian_filter(feats, v)
    if filter_kind == "rff":
        # the RFF surrogate rescaled by the calibrated ``convention`` into
        # the reference lattice's energy scale (resolve_energy_convention)
        dtype = torch.bfloat16 if half else torch.float32
        return lambda v: convention * rff_gaussian_filter(
            feats, v, n_features=rff_features, seed=rff_seed, dtype=dtype)
    if filter_kind == "lattice":
        # the reference's own filter: built once, applied once
        lat = build_lattice(feats)
        return lambda v: apply_lattice(lat, v)
    raise ValueError(filter_kind)


class DenseEnergy(torch.autograd.Function):
    """loss = -<seg_roi, filter(seg_roi) * gate> / B, with the reference's
    gradient convention -2 g AS_gated / B for seg_roi (the ROI factor is
    applied by the chain rule through seg_roi = probs * ROI upstream).
    ``filter_fn`` maps (B, N, K) values to their filtered values."""

    @staticmethod
    def forward(ctx, seg_roi, gate, filter_fn):
        b, h, w, k = seg_roi.shape
        as_gated = filter_fn(seg_roi.reshape(b, h * w, k)).reshape(b, h, w, k) * gate
        ctx.save_for_backward(as_gated)
        ctx.n = b
        return -(seg_roi * as_gated).sum() / b

    @staticmethod
    def backward(ctx, g):
        (as_gated,) = ctx.saved_tensors
        return -2.0 * g * as_gated / ctx.n, None, None


def get_energy_loss(
    img: torch.Tensor,
    seg_logits: torch.Tensor,
    label: torch.Tensor,
    img_box: torch.Tensor,
    weight: float = 1e-7,
    sigma_rgb: float = 15.0,
    sigma_xy: float = 100.0,
    scale_factor: float = 0.5,
    filter_kind: str = "rff",
    rff_features: int = 1024,
    rff_seed: int = 0,
    ignore_index: int = 255,
    half: bool = False,
    convention: float = 1.0,
) -> torch.Tensor:
    """img: normalized NHWC; seg_logits: (B, H, W, C) at label resolution;
    label: (B, H, W) pseudo mask; img_box: (B, 4)."""
    b, h, w, _ = img.shape
    probs = torch.softmax(seg_logits.to(torch.float32), dim=-1)
    rois = box_mask(img_box, h, w).to(torch.float32)

    sh, sw = int(h * scale_factor), int(w * scale_factor)
    s_img = resize_nearest(denormalize_u8(img), (sh, sw))
    s_probs = resize_bilinear(probs, (sh, sw))
    s_rois = resize_nearest(rois, (sh, sw))
    s_label = resize_nearest(label, (sh, sw))

    unlabeled = s_label == ignore_index
    seg_max = s_probs.amax(dim=-1)
    gate = torch.clamp(s_rois - seg_max, min=0.0)
    gate = torch.where(unlabeled, torch.ones_like(gate), gate)[..., None].detach()

    seg_roi = s_probs * s_rois[..., None]
    feats = pixel_features(s_img, sigma_rgb, sigma_xy * scale_factor).detach()
    feats = feats.reshape(b, sh * sw, -1)
    filter_fn = _filter_fn(feats, filter_kind, rff_features, rff_seed, half, float(convention))
    return weight * DenseEnergy.apply(seg_roi, gate, filter_fn)


def resolve_energy_convention(cfg, images_u8, device=None, n_probe: int = 2):
    """Calibrate the rff->lattice energy convention on real images at the
    energy resolution the run uses (the JAX package's procedure, which this
    mirrors): sum(E_lattice) / sum(E_rff) with E = <v, filter(v)> over two
    smooth softmax probe fields. The lattice side is the native C++
    permutohedral filter on the host; the RFF side runs the training
    configuration (n_features, bf16-ness) on ``device``.

    Returns (convention, info_dict)."""
    from cosa_tpu_torch.native.build import lattice_gaussian_cpu

    dev = torch.device("cpu") if device is None else torch.device(device)
    imgs = torch.as_tensor(np.asarray(images_u8[:4]), dtype=torch.float32)
    b, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    c = cfg.num_classes
    sh, sw = max(1, int(h * cfg.energy_scale)), max(1, int(w * cfg.energy_scale))
    s_img = resize_nearest(imgs, (sh, sw))
    feats = pixel_features(s_img, cfg.energy_sigma_rgb, cfg.energy_sigma_xy * cfg.energy_scale)
    f_flat = feats.reshape(b, sh * sw, 5).numpy()

    rng = np.random.default_rng(cfg.seed + 17)
    gh, gw = max(1, sh // 8), max(1, sw // 8)
    ratios = []
    for _, amp in zip(range(n_probe), (2.0, 8.0)):
        logits = rng.standard_normal((b, gh, gw, c)).astype(np.float32) * amp
        logits = resize_bilinear(torch.from_numpy(logits), (sh, sw))
        v_flat = torch.softmax(logits, dim=-1).reshape(b, sh * sw, c)
        rff_out = rff_gaussian_filter(
            torch.from_numpy(f_flat).to(dev), v_flat.to(dev),
            n_features=cfg.energy_rff_features, seed=0,
            dtype=torch.bfloat16 if cfg.mixed_precision else torch.float32,
        )
        e_rff = float((v_flat.to(dev) * rff_out).sum())
        v_np = v_flat.numpy()
        lat = np.stack([lattice_gaussian_cpu(f_flat[i], v_np[i]) for i in range(b)])
        e_lat = float(np.vdot(v_np, lat))
        ratios.append(e_lat / e_rff)

    conv = float(np.mean(ratios))
    info = dict(
        per_probe=[round(r, 4) for r in ratios],
        spread=round(float(np.max(ratios) - np.min(ratios)), 4),
        energy_res=(sh, sw),
    )
    if not 0.2 < conv < 1.5:
        raise RuntimeError(
            f"energy convention calibration out of sane band: {conv} {info}"
        )
    return conv, info
