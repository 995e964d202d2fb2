"""Evaluation: multi-scale + flip TTA, CAM / seg labels, confusion matrices.

Port of the JAX package's eval/engine.py::evaluate (itself the twin of the
reference's evaluation_engine.py:11-297), for one GPU:

  * batches of ``cfg.eval_batch`` val images; each image resized to the
    crop-size square (bilinear, align_corners=False, no antialias: what the
    JAX package's on-device interpolation matrices compute);
  * ``multi_scale_camseg`` over ``cfg.eval_scales`` with flips, and the
    image-level logits;
  * each image's CAM / aux-CAM / seg maps resized to its own ground-truth
    size and laid on the zero P x P canvas of the JAX package (P = 500 for
    VOC12, 640 otherwise), where the threshold filters and the DenseCRF
    run: both downsample, and their results depend on the canvas (the
    host CRF backends, ``crf_backend`` "native" / "jax", instead refine
    each image at its own size from its cropped seg probabilities, at
    batch 1, as the JAX package does);
  * CAM, aux-CAM, Seg_ps and Seg_vd confusion matrices (+ one per threshold
    filter and head, + Seg_crf) accumulated on the device, fetched once at
    the end; the classification mAP per image.

The static-shape interpolation matrices and the single packed transfer of
the JAX package are TPU devices that a GPU does not need. Multi-GPU
evaluation (``mesh``) is ROADMAP Queue 1 item 14.

:func:`_eval_batch` is the one batch path of scoring, of the evaluation
visuals (``save_dir``, raw CAM dumps) and of the test-split submission
(``eval/submit.py``): asked for them, it also returns each image's canvas
maps.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cosa_tpu_torch.data.datasets import class_list
from cosa_tpu_torch.eval.crf import crf_labels_device, crf_refine_host
from cosa_tpu_torch.eval.metrics import scores_from_hist, torch_hist
from cosa_tpu_torch.models.network import require_cosa_interface
from cosa_tpu_torch.objectives.pseudo import (
    box_mask,
    cam2mask,
    cam_to_label,
    cam_validation,
    multi_scale_camseg,
    seg_validation,
)
from cosa_tpu_torch.ops.image import normalize
from cosa_tpu_torch.ops.resize import resize_bilinear
from cosa_tpu_torch.utils.device import resolve_device
from cosa_tpu_torch.utils.metrics import compute_mAP
from cosa_tpu_torch.utils.visualize import dump_eval_visuals

SUBSET_SEED = 20240817  # the JAX package's seeded max_images subset (engine.py:276)


def eval_indices(n: int, max_images: Optional[int]) -> List[int]:
    """All of ``range(n)``, or the JAX package's fixed seeded subset of
    ``max_images`` of them (sorted), so both packages score the same images."""
    if max_images and max_images < n:
        sub = np.random.default_rng(SUBSET_SEED).permutation(n)[:max_images]
        return sorted(int(i) for i in sub)
    return list(range(n))


def score_names(res: Dict) -> List[str]:
    """The keys of :func:`evaluate`'s result that hold mIoU scores."""
    return [k for k in res if k not in ("cls_aps", "time")]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _canvas(maps: torch.Tensor, sizes, pad: int) -> torch.Tensor:
    """(B, s, s, C) crop-size maps -> (B, pad, pad, C): each image's maps
    resized to its (h, w) at the top left, zero elsewhere."""
    out = maps.new_zeros((maps.shape[0], pad, pad, maps.shape[-1]))
    for i, (h, w) in enumerate(sizes):
        out[i, :h, :w] = resize_bilinear(maps[i:i + 1], (h, w))[0]
    return out


def evaluate(
    cfg,
    model: torch.nn.Module,
    val_ds,
    getcrf: bool = False,
    threshold_filters: Optional[Sequence[float]] = None,
    max_images: Optional[int] = None,
    save_dir: Optional[str] = None,
    save_rawcam_dir: Optional[str] = None,
    mesh=None,
    device=None,
) -> Dict:
    """Score ``model`` (on ``device``; default the GPU) on ``val_ds``.

    Returns {'CAM': scores, 'aux_CAM', 'Seg_ps', 'Seg_vd', 'cls_aps': (mAP,
    mAP_aux), ['cam_{t}', 'camaux_{t}' per threshold filter], ['Seg_crf'],
    'time': {'images', 'seconds', 'crf_seconds'}}, each scores entry as
    :func:`~cosa_tpu_torch.eval.metrics.scores_from_hist` gives it.

    ``save_dir`` receives each image's seg PNG and CAM overlays
    (``utils/visualize.py::dump_eval_visuals``), ``save_rawcam_dir`` its
    CAMs of the present classes as a ``{class: map}`` ``.npy``."""
    require_cosa_interface(cfg)
    if mesh is not None:
        raise NotImplementedError("mesh: multi-GPU evaluation is ROADMAP Queue 1 item 14")
    dev = resolve_device(device)
    thresholds = tuple(threshold_filters or ())
    n = cfg.num_classes
    pad = 500 if cfg.dataset == "VOC12" else 640
    idxs = eval_indices(len(val_ds), max_images)
    # the host CRF backends take one image's probabilities at a time
    bsz = 1 if getcrf and cfg.crf_backend != "device" else int(cfg.eval_batch)
    hists = torch.zeros((4 + 2 * len(thresholds) + int(getcrf), n, n),
                        dtype=torch.int64, device=dev)
    aps: List[float] = []
    aps_aux: List[float] = []
    crf_s = 0.0
    t0 = time.time()
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for c0 in range(0, len(idxs), bsz):
                samples = [val_ds[i] for i in idxs[c0:c0 + bsz]]
                h_b, probs, probs_aux, dt, maps = _eval_batch(
                    cfg, model, samples, pad, thresholds, getcrf, dev,
                    return_maps=bool(save_dir or save_rawcam_dir))
                if maps is not None:
                    _dump_maps(cfg, samples, maps, save_dir, save_rawcam_dir)
                hists += h_b
                crf_s += dt
                for bi, smp in enumerate(samples):
                    cl = smp["cls_label"]
                    if cl.sum() > 0:
                        aps += compute_mAP(cl[None], probs[bi:bi + 1])
                        aps_aux += compute_mAP(cl[None], probs_aux[bi:bi + 1])
    finally:
        model.train(was_training)
    hist = hists.cpu().numpy()
    out = {
        "CAM": scores_from_hist(hist[0]),
        "aux_CAM": scores_from_hist(hist[1]),
        "Seg_ps": scores_from_hist(hist[2]),
        "Seg_vd": scores_from_hist(hist[3]),
        "cls_aps": (float(np.mean(aps)) if aps else 0.0,
                    float(np.mean(aps_aux)) if aps_aux else 0.0),
    }
    for ti, thre in enumerate(thresholds):
        out[f"cam_{thre}"] = scores_from_hist(hist[4 + 2 * ti])
        out[f"camaux_{thre}"] = scores_from_hist(hist[5 + 2 * ti])
    if getcrf:
        out["Seg_crf"] = scores_from_hist(hist[-1])
    out["time"] = dict(images=len(idxs), seconds=time.time() - t0, crf_seconds=crf_s)
    return out


def _dump_maps(cfg, samples, maps, save_dir, rawcam_dir) -> None:
    """Each image's visuals and raw CAMs from :func:`_eval_batch`'s maps."""
    n = cfg.num_classes
    seg_vd, r_cam = maps["seg_vd"].cpu().numpy(), maps["r_cam"].cpu().numpy()
    names = class_list(cfg.dataset, cfg.split_dir) if save_dir else None
    for i, smp in enumerate(samples):
        h, w = smp["image"].shape[:2]
        cam_map = r_cam[i, :h, :w]
        if rawcam_dir:
            # reference save_cam_npv2 (evaluation_engine.py:299-309): per
            # image, {class index: CAM map} over its present classes
            os.makedirs(rawcam_dir, exist_ok=True)
            cam_dict = {int(c): cam_map[..., c] for c in range(n - 1)
                        if smp["cls_label"][c] > 0}
            if cam_dict:
                np.save(os.path.join(rawcam_dir, smp["name"] + ".npy"), cam_dict)
        if save_dir:
            dump_eval_visuals(save_dir, smp["name"], smp["image"], seg_vd[i, :h, :w],
                              cam_map, smp["label"], smp["cls_label"], names, n)


def _eval_batch(cfg, model, samples, pad, thresholds, getcrf, dev, return_maps=False):
    """One batch: its stacked confusion matrices on the device, the
    image-level probabilities of both heads on the host, the seconds the
    CRF took, and (with ``return_maps``, else None) the canvas maps on the
    device: ``seg_vd`` (B, P, P) validated seg labels, ``r_cam`` (B, P, P,
    C-1) CAMs and, with ``getcrf``, ``crf`` (B, P, P) the refined labels
    (the host backends' single image at its top left, 0 elsewhere)."""
    n = cfg.num_classes
    sizes = [smp["image"].shape[:2] for smp in samples]
    biggest = max(max(hw) for hw in sizes)
    # images larger than the canvas: the JAX package's next multiple of 128
    pad = pad if biggest <= pad else -(-biggest // 128) * 128
    s = cfg.crop_size
    imgs = torch.cat([
        resize_bilinear(normalize(torch.from_numpy(smp["image"]).to(dev)[None]), (s, s))
        for smp in samples])
    cls = torch.from_numpy(np.stack([smp["cls_label"] for smp in samples])).to(
        dev, torch.float32)
    cam, cam_aux, seg, cls_f, cls_a = multi_scale_camseg(
        model, imgs, cfg.eval_scales, getcls=True)
    r_cam, r_cam_aux, r_seg = (_canvas(x, sizes, pad) for x in (cam, cam_aux, seg))
    gt = torch.full((len(samples), pad, pad), 255, dtype=torch.int64, device=dev)
    for i, (h, w) in enumerate(sizes):
        gt[i, :h, :w] = torch.from_numpy(samples[i]["label"].astype(np.int64)).to(dev)

    seg_vd = torch.argmax(seg_validation(r_seg, cls), dim=-1)
    hs = [
        torch_hist(gt, cam_to_label(r_cam, cls, bkg_thre=cfg.bkg_thre), n),
        torch_hist(gt, cam_to_label(r_cam_aux, cls, bkg_thre=cfg.bkg_thre), n),
        torch_hist(gt, torch.argmax(r_seg, dim=-1), n),
        torch_hist(gt, seg_vd, n),
    ]
    if thresholds:
        # the JAX package's box: rows and columns up to h - 1, w - 1
        box = torch.tensor([[0, h - 1, 0, w - 1] for h, w in sizes], device=dev)
        valid_cams = (cam_validation(r_cam, cls), cam_validation(r_cam_aux, cls))
        for thre in thresholds:
            for vc in valid_cams:
                lab = cam2mask(img_box=box, cams=vc, cls_labels=cls,
                               threshold_high=1.0 - thre, threshold_low=thre,
                               downscale=cfg.par_downscale,
                               ignore_index=cfg.ignore_index)
                # pseudo-score convention (utils/evaluation.py:41-44)
                ign = lab == 255
                hs.append(torch_hist(torch.where(ign, 255, gt),
                                     torch.where(ign, 0, lab), n))
    crf_s = 0.0
    maps = dict(seg_vd=seg_vd, r_cam=r_cam) if return_maps else None
    if getcrf:
        _sync(dev)
        t = time.time()
        vd_probs = torch.softmax(seg_validation(r_seg, cls), dim=-1)
        if cfg.crf_backend == "device":
            img_c = torch.zeros((len(samples), pad, pad, 3), dtype=torch.float32, device=dev)
            for i, (h, w) in enumerate(sizes):
                img_c[i, :h, :w] = torch.from_numpy(samples[i]["image"]).to(dev)
            valid = box_mask(torch.tensor([[0, h, 0, w] for h, w in sizes], device=dev),
                             pad, pad).to(torch.float32)
            crf = crf_labels_device(cfg, img_c, vd_probs, valid)
            hs.append(torch_hist(gt, crf, n))
        else:  # one image (batch 1), its probabilities at its own size
            (h, w), img = sizes[0], torch.from_numpy(samples[0]["image"]).to(dev)
            lab = crf_refine_host(cfg, img, vd_probs[0, :h, :w])
            hs.append(torch_hist(gt[0, :h, :w], lab, n))
            crf = torch.zeros_like(seg_vd, dtype=lab.dtype)
            crf[0, :h, :w] = lab
        _sync(dev)
        crf_s = time.time() - t
        if maps is not None:
            maps["crf"] = crf
    probs = torch.sigmoid(torch.stack([cls_f, cls_a])).cpu().numpy()
    return torch.stack(hs), probs[0], probs[1], crf_s, maps
