"""Eval-server submission dumps for the ground-truth-less test split.

Port of the JAX package's eval/submit.py: the val engine's TTA inference
(``eval/engine.py::_eval_batch``, the same batch path), the seg argmax
after class validation (the test split's class labels are all ones, so it
is the raw argmax), the CRF by backend, and one indexed-palette PNG per
image in the layout the PASCAL VOC evaluation server expects:

  {out}/results/VOC2012/Segmentation/comp6_test_cls/{name}.png

(comp6 is the segmentation-from-additional-data track CoSA competes in;
``tar -czf results.tgz results/`` of the dump directory is uploadable.)
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from PIL import Image

from cosa_tpu_torch.data.datasets import SyntheticBase
from cosa_tpu_torch.eval.engine import _eval_batch
from cosa_tpu_torch.models.network import require_cosa_interface
from cosa_tpu_torch.utils.device import resolve_device
from cosa_tpu_torch.utils.visualize import save_seg


def submission_dir(out_dir: str, dataset: str = "VOC12") -> str:
    # the eval server unpacks results/VOC2012/Segmentation/comp6_test_cls/
    server_name = {"VOC12": "VOC2012"}.get(dataset, dataset)
    return os.path.join(out_dir, "results", server_name, "Segmentation", "comp6_test_cls")


def _image_size(test_ds, i: int):
    """(h, w) from the image file's header (PIL opens lazily), so planning
    the pad buckets decodes no image; a synthetic image is drawn."""
    base = test_ds.base
    if isinstance(base, SyntheticBase):  # no file to read
        return test_ds[i]["image"].shape[:2]
    with Image.open(base._paths(base.names[i])[0]) as im:
        return im.size[1], im.size[0]


def dump_submission(
    cfg,
    model: torch.nn.Module,
    test_ds,
    out_dir: str,
    use_crf: bool = True,
    max_images: Optional[int] = None,
    device=None,
) -> str:
    """Write one palette PNG per image of ``test_ds`` (its first
    ``max_images``), with ``model`` on ``device`` (default: the GPU).
    Images are grouped by canvas: 500 for VOC12 (else 640), or the next
    multiple of 128 above. Under ``crf_backend="device"`` the CRF refines
    each batch's canvas on the device; the host backends refine one image
    at a time (batch 1) from its cropped validated probabilities. Returns
    the directory holding the PNGs."""
    require_cosa_interface(cfg)
    dev = resolve_device(device)
    dst = submission_dir(out_dir, cfg.dataset)
    os.makedirs(dst, exist_ok=True)
    pad = 500 if cfg.dataset == "VOC12" else 640
    n_total = len(test_ds) if max_images is None else min(max_images, len(test_ds))
    bsz = 1 if use_crf and cfg.crf_backend != "device" else int(cfg.eval_batch)
    buckets = {}
    for i in range(n_total):
        m = max(_image_size(test_ds, i))
        buckets.setdefault(pad if m <= pad else -(-m // 128) * 128, []).append(i)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for pad_i, members in sorted(buckets.items()):
                for c0 in range(0, len(members), bsz):
                    samples = [test_ds[i] for i in members[c0:c0 + bsz]]
                    maps = _eval_batch(cfg, model, samples, pad_i, (), use_crf, dev,
                                       return_maps=True)[-1]
                    pred = maps["crf" if use_crf else "seg_vd"].cpu().numpy()
                    for bi, smp in enumerate(samples):
                        h, w = smp["image"].shape[:2]
                        save_seg(pred[bi, :h, :w], os.path.join(dst, smp["name"] + ".png"),
                                 cfg.num_classes)
    finally:
        model.train(was_training)
    return dst
