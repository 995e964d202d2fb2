"""Visualization: palette segmentation PNGs + CAM heatmap overlays.

Twin of reference utils/seg_helper.py:12-189 (save_seg / save_cam_on_image /
save_merge + the VOC-21 and 81-class palettes). cv2-free: the jet colormap
is evaluated directly. A copy of the JAX package's utils/visualize.py
(numpy + PIL): the same arrays give byte-identical files.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image


def voc_palette(n: int = 21) -> np.ndarray:
    """Standard VOC bit-interleaved palette (matches the reference's PALETTE
    constant for the first 21 entries)."""
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        c, j = i, 0
        while c:
            pal[i, 0] |= ((c >> 0) & 1) << (7 - j)
            pal[i, 1] |= ((c >> 1) & 1) << (7 - j)
            pal[i, 2] |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
            j += 1
    return pal[:n]


def spectral_palette(n: int = 81) -> np.ndarray:
    """Spectral-like ramp for many-class datasets (reference PALETTE81 role)."""
    xs = np.linspace(0.0, 1.0, max(n - 1, 1))
    # piecewise ramp through dark-red -> orange -> yellow -> green -> blue
    anchors = np.array(
        [[158, 1, 66], [244, 109, 67], [255, 255, 190], [102, 194, 165],
         [94, 79, 162]], np.float32,
    )
    t = xs * (len(anchors) - 1)
    i0 = np.clip(t.astype(int), 0, len(anchors) - 2)
    frac = (t - i0)[:, None]
    ramp = anchors[i0] * (1 - frac) + anchors[i0 + 1] * frac
    return np.concatenate([[[0, 0, 0]], ramp], axis=0).astype(np.uint8)[:n]


def save_seg(seg: np.ndarray, path: str, num_classes: int = 21) -> None:
    """Save an argmax label map as a palette PNG (reference save_seg)."""
    img = Image.fromarray(seg.astype(np.uint8), mode="P")
    pal = voc_palette(256) if num_classes <= 28 else np.concatenate(
        [spectral_palette(num_classes), np.zeros((256 - num_classes, 3), np.uint8)]
    )
    img.putpalette(pal.flatten().tolist())
    img.save(path)


def _jet(x: np.ndarray) -> np.ndarray:
    """Jet colormap on [0, 1] -> uint8 RGB."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def cam_overlay(img_rgb: np.ndarray, cam: np.ndarray) -> np.ndarray:
    """CAM heatmap blended over the image (reference save_cam_on_image:
    heatmap + img, renormalized)."""
    base = img_rgb.astype(np.float32) / 255.0
    heat = _jet(cam).astype(np.float32) / 255.0
    out = heat + base
    out = out / out.max()
    return (out * 255).astype(np.uint8)


def save_cam_on_image(img_rgb: np.ndarray, cam: np.ndarray, path: str) -> None:
    Image.fromarray(cam_overlay(img_rgb, cam)).save(path)


def save_merge(
    img_rgb: np.ndarray,
    cam: np.ndarray,
    gt_mask: np.ndarray,
    seg_mask: np.ndarray,
    path: str,
) -> None:
    """Side-by-side CAM overlay | binary seg | binary GT | image
    (reference save_merge)."""
    teal = np.array([10, 186, 181], np.uint8)

    def bin_rgb(m):
        out = np.zeros((*m.shape, 3), np.uint8)
        out[m.astype(bool)] = teal
        return out

    merged = np.concatenate(
        [cam_overlay(img_rgb, cam), bin_rgb(seg_mask), bin_rgb(gt_mask),
         img_rgb.astype(np.uint8)],
        axis=1,
    )
    Image.fromarray(merged).save(path)


def dump_eval_visuals(
    out_dir: str,
    name: str,
    img_rgb: np.ndarray,
    seg: np.ndarray,
    cams: np.ndarray,
    gt: np.ndarray,
    cls_label: np.ndarray,
    class_names: Sequence[str],
    num_classes: int,
) -> None:
    """Per-image artifact dump used by evaluate(save_dir=...)
    (reference evaluation_engine.py:160-198)."""
    os.makedirs(os.path.join(out_dir, "seg"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "cam"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "merged"), exist_ok=True)
    save_seg(seg, os.path.join(out_dir, "seg", name + ".png"), num_classes)
    for j, present in enumerate(cls_label):
        if present > 0:
            cname = class_names[j + 1]
            save_cam_on_image(
                img_rgb, cams[..., j],
                os.path.join(out_dir, "cam", f"{name}_{cname}.png"),
            )
            save_merge(
                img_rgb, cams[..., j], gt == (j + 1), seg == (j + 1),
                os.path.join(out_dir, "merged", f"{name}_{cname}.png"),
            )
