"""Pseudo-label generation: CAM -> (PAR) -> (CRF) for a dataset split.

Port of the JAX package's eval/pseudo_pipeline.py (the pipeline behind its
BASELINE configs #1/#2): given a model, produce the multi-scale fused CAM
and the hard pseudo mask of each image, one image (and its flip) per
forward, optionally PAR-refined and CRF-polished; save the masks as
palette PNGs and the CAMs as raw ``.npy``, and score the masks against
the ground truth with the pseudo-score convention (255 does not count).

The CRF runs on the host at each image's own size. Under the default
``crf_backend="device"`` it is the port's native C++ lattice
(``eval/crf.py::crf_refine_native``), the backend the JAX pipeline takes
first there; a failed g++ build raises (the JAX pipeline would fall back
to its own lattice). ``"native"`` and ``"jax"`` go through
``crf_refine_host``.

CLI: python -m cosa_tpu_torch.cli.make_pseudo run_name --dataset VOC12 ...
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cosa_tpu_torch.eval.crf import crf_refine_host, crf_refine_native
from cosa_tpu_torch.eval.metrics import fast_hist, scores_from_hist
from cosa_tpu_torch.models.network import require_cosa_interface
from cosa_tpu_torch.objectives.pseudo import cam2mask, cam_validation, multi_scale_camseg
from cosa_tpu_torch.ops.image import denormalize01, normalize
from cosa_tpu_torch.ops.par import par_refine
from cosa_tpu_torch.ops.resize import _linear_matrix, np_resize_bilinear
from cosa_tpu_torch.utils.device import resolve_device
from cosa_tpu_torch.utils.visualize import save_seg

Step = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _to_crop(img: torch.Tensor, s: int) -> torch.Tensor:
    """(1, h, w, 3) -> (1, s, s, 3) bilinear (align_corners=False) as the
    JAX package computes it, two products with its interpolation
    matrices. Under PAR the result is denormalized with uint8 truncation,
    where flat image regions land on exact integers: ``F.interpolate``
    rounds otherwise and moves some of them down by 1/255."""
    _, h, w, _ = img.shape
    mh = torch.from_numpy(_linear_matrix(h, s)).to(img.device)
    mw = torch.from_numpy(_linear_matrix(w, s)).to(img.device)
    y = torch.einsum("sh,bhwc->bswc", mh, img)
    return torch.einsum("tw,bswc->bstc", mw, y)


def build_pseudo_step(cfg, model) -> Step:
    """(1, h, w, 3) uint8 image, (1, C-1) class labels -> the validated
    fused CAM (1, s, s, C-1), the pseudo mask (1, s, s) and the softmax of
    the unvalidated seg logits (1, s, s, C), at s = ``cfg.crop_size``."""
    s = cfg.crop_size
    refine_fn = None
    if cfg.usepar:
        def refine_fn(imgs, probs):
            return par_refine(imgs, probs, dilations=cfg.par_dilations,
                              num_iter=cfg.par_iters)

    def step(img_u8, cls_label):
        img_s = _to_crop(normalize(img_u8), s)
        cam, _, seg = multi_scale_camseg(model, img_s, cfg.pseudo_scales)
        valid_cam = cam_validation(cam, cls_label)
        box = torch.tensor([[0, s, 0, s]], device=img_u8.device)
        mask = cam2mask(img_box=box, cams=valid_cam, cls_labels=cls_label,
                        threshold_high=cfg.high_thre, threshold_low=cfg.low_thre,
                        downscale=cfg.par_downscale, ignore_index=cfg.ignore_index,
                        refine_fn=refine_fn,
                        images=denormalize01(img_s) if cfg.usepar else None)
        return valid_cam, mask, torch.softmax(seg, dim=-1)

    return step


def generate_pseudo_labels(
    cfg,
    model: torch.nn.Module,
    dataset,
    out_dir: str,
    max_images: Optional[int] = None,
    use_crf: bool = False,
    device=None,
) -> Dict:
    """Run the pipeline over the first ``max_images`` (default all) images
    of a SegValDataset split on ``device`` (default: the GPU). Writes
    ``{out_dir}/mask/{name}.png`` (palette) and ``{out_dir}/cam/{name}.npy``
    (the crop-resolution validated CAM); returns the masks' scores
    (:func:`~cosa_tpu_torch.eval.metrics.scores_from_hist`)."""
    require_cosa_interface(cfg)
    dev = resolve_device(device)
    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "cam"), exist_ok=True)
    step = build_pseudo_step(cfg, model)
    s = cfg.crop_size
    n = cfg.num_classes
    hist = np.zeros((n, n), np.int64)
    count = len(dataset) if max_images is None else min(max_images, len(dataset))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for i in range(count):
                smp = dataset[i]
                img, gt = smp["image"], smp["label"]
                h, w = img.shape[:2]
                img_t = torch.from_numpy(img.copy()).to(dev)
                cls = torch.from_numpy(smp["cls_label"][None]).to(dev, torch.float32)
                cam, mask, seg_probs = step(img_t[None], cls)
                # back to the image's size on the host: the JAX package's
                # nearest indices for the hard mask
                ys = (np.arange(h) * s / h).astype(int).clip(0, s - 1)
                xs = (np.arange(w) * s / w).astype(int).clip(0, s - 1)
                mask_hw = mask[0].cpu().numpy()[ys][:, xs]
                if use_crf:
                    probs_hw = np_resize_bilinear(seg_probs[0].cpu().numpy(), (h, w))
                    probs_hw = np.clip(probs_hw, 1e-8, 1.0)
                    probs_hw = probs_hw / probs_hw.sum(-1, keepdims=True)
                    if cfg.crf_backend == "device":
                        mask_hw = crf_refine_native(cfg, img, probs_hw)
                    else:
                        mask_hw = crf_refine_host(
                            cfg, img_t, torch.from_numpy(probs_hw).to(dev)).cpu().numpy()
                mask_hw = mask_hw.astype(np.uint8)
                save_seg(mask_hw, os.path.join(out_dir, "mask", smp["name"] + ".png"), n)
                np.save(os.path.join(out_dir, "cam", smp["name"] + ".npy"),
                        cam[0].cpu().numpy())
                # pseudo-score convention: the ignore band (255) does not count
                gt64, m64 = gt.astype(np.int64), mask_hw.astype(np.int64)
                gt64 = np.where(m64 == 255, 255, gt64)
                m64 = np.where(m64 == 255, 0, m64)
                hist += fast_hist(gt64.flatten(), m64.flatten(), n)
    finally:
        model.train(was_training)
    return scores_from_hist(hist)
