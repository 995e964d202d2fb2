"""Legacy image utilities (the JAX package's data/imutils.py; reference
dataloaders/imutils.py, an AFFiNity-era collection the live path never
imports).

The transforms keep the reference's names and semantics with an explicit
``numpy.random.Generator`` (the replayability contract of
data/transforms.py), on PIL and numpy. ``random_resize_long`` resizes,
where the reference computes the target shape and returns the input
(imutils.py:53-68). The mean-field wrappers (``crf_inference``,
``crf_inference_inf``, ``crf_inference_label``, imutils.py:345-402) run on
the port's native C++ lattice (native/build.py); a failed build raises,
where the JAX package falls back to an O((HW)^2) numpy bilateral.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image, ImageOps

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def normalize_img(img: np.ndarray, mean=_MEAN, std=_STD) -> np.ndarray:
    """imutils Normalize/Normalize2 (:23-37, :404-417): uint8 HWC ->
    ImageNet-normalized float32 HWC."""
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def random_resize_long(rng: np.random.Generator, img: Image.Image,
                       min_long: int, max_long: int) -> Image.Image:
    """imutils RandomResizeLong (:53-68) — actually resizing (the reference
    computes target_shape then forgets to use it)."""
    target = int(rng.integers(min_long, max_long + 1))
    w, h = img.size
    if w < h:
        shape = (int(round(w * target / h)), target)
    else:
        shape = (target, int(round(h * target / w)))
    return img.resize(shape, Image.BILINEAR)


def fix_scale_crop(img: Image.Image, crop_size: int) -> Image.Image:
    """imutils FixScaleCropImage (:107-125): scale short side to crop_size,
    center-crop."""
    w, h = img.size
    if w > h:
        oh, ow = crop_size, int(1.0 * w * crop_size / h)
    else:
        ow, oh = crop_size, int(1.0 * h * crop_size / w)
    img = img.resize((ow, oh), Image.BILINEAR)
    w, h = img.size
    x1 = int(round((w - crop_size) / 2.0))
    y1 = int(round((h - crop_size) / 2.0))
    return img.crop((x1, y1, x1 + crop_size, y1 + crop_size))


def get_random_crop_box(rng: np.random.Generator, imgsize: Tuple[int, int],
                        cropsize: int) -> Tuple[int, ...]:
    """imutils get_random_crop_box (:167-190): 8-tuple
    (cont_top, cont_bot, cont_left, cont_right, img_top, img_bot,
    img_left, img_right) placing a crop window in a cropsize canvas."""
    h, w = imgsize
    ch, cw = min(cropsize, h), min(cropsize, w)
    w_space, h_space = w - cropsize, h - cropsize
    if w_space > 0:
        cont_left, img_left = 0, int(rng.integers(0, w_space + 1))
    else:
        cont_left, img_left = int(rng.integers(0, -w_space + 1)), 0
    if h_space > 0:
        cont_top, img_top = 0, int(rng.integers(0, h_space + 1))
    else:
        cont_top, img_top = int(rng.integers(0, -h_space + 1)), 0
    return (cont_top, cont_top + ch, cont_left, cont_left + cw,
            img_top, img_top + ch, img_left, img_left + cw)


def crop_with_box(img: np.ndarray, box: Sequence[int]) -> np.ndarray:
    """imutils crop_with_box (:192-198), reference quirk preserved: the
    height term mixes box[4]-box[5] (<= 0), so the canvas is
    max(cont-span, img-span) per axis exactly as written."""
    hh = max(box[1] - box[0], box[4] - box[5])
    ww = max(box[3] - box[2], box[7] - box[6])
    shape = (hh, ww, img.shape[-1]) if img.ndim == 3 else (hh, ww)
    cont = np.zeros(shape, img.dtype)
    cont[box[0]:box[1], box[2]:box[3]] = img[box[4]:box[5], box[6]:box[7]]
    return cont


def random_crop(rng: np.random.Generator, images: Sequence, cropsize: int,
                fills: Sequence) -> List:
    """imutils random_crop (:201-226): one shared crop box applied to a list
    of PIL images / numpy arrays, each padded with its own fill value."""
    first = images[0]
    imgsize = first.size[::-1] if isinstance(first, Image.Image) else first.shape[:2]
    box = get_random_crop_box(rng, imgsize, cropsize)
    out: List = []
    for img, f in zip(images, fills):
        if isinstance(img, Image.Image):
            img = img.crop((box[6], box[4], box[7], box[5]))
            cont = Image.new(img.mode, (cropsize, cropsize))
            cont.paste(img, (box[2], box[0]))
            out.append(cont)
        else:
            shape = ((cropsize, cropsize, img.shape[2]) if img.ndim == 3
                     else (cropsize, cropsize))
            cont = np.ones(shape, img.dtype) * f
            cont[box[0]:box[1], box[2]:box[3]] = img[box[4]:box[5], box[6]:box[7]]
            out.append(cont)
    return out


def center_crop(npimg: np.ndarray, cropsize: int,
                default_value=0) -> np.ndarray:
    """imutils CenterCrop (:249-288): pad-or-crop to cropsize^2 around the
    center."""
    h, w = npimg.shape[:2]
    ch, cw = min(cropsize, h), min(cropsize, w)
    sh, sw = h - cropsize, w - cropsize
    cont_left, img_left = (0, int(round(sw / 2))) if sw > 0 else (int(round(-sw / 2)), 0)
    cont_top, img_top = (0, int(round(sh / 2))) if sh > 0 else (int(round(-sh / 2)), 0)
    shape = ((cropsize, cropsize) if npimg.ndim == 2
             else (cropsize, cropsize, npimg.shape[2]))
    cont = np.ones(shape, npimg.dtype) * default_value
    cont[cont_top:cont_top + ch, cont_left:cont_left + cw] = \
        npimg[img_top:img_top + ch, img_left:img_left + cw]
    return cont


def avg_pool2d(img: np.ndarray, ksize: int) -> np.ndarray:
    """imutils AvgPool2d (:228-236, skimage.block_reduce): non-overlapping
    ksize x ksize mean pooling with zero-padded remainder blocks."""
    h, w = img.shape[:2]
    ph, pw = -h % ksize, -w % ksize
    pad = ((0, ph), (0, pw)) + ((0, 0),) * (img.ndim - 2)
    x = np.pad(img.astype(np.float64), pad)
    hh, ww = x.shape[0] // ksize, x.shape[1] // ksize
    x = x.reshape((hh, ksize, ww, ksize) + x.shape[2:])
    return x.mean(axis=(1, 3))


def rescale_nearest(npimg: np.ndarray, scale: float) -> np.ndarray:
    """imutils RescaleNearest (:297-304, cv2.INTER_NEAREST): source index
    floor(i / scale) — cv2's nearest has no half-pixel-center shift
    (verified: 4x4 arange at scale 0.5 -> [[0, 2], [8, 10]])."""
    h, w = npimg.shape[:2]
    new_w, new_h = int(w * scale), int(h * scale)
    ys = np.minimum(np.arange(new_h) / scale, h - 1).astype(np.int64)
    xs = np.minimum(np.arange(new_w) / scale, w - 1).astype(np.int64)
    return npimg[ys][:, xs]


def random_scale_crop(rng: np.random.Generator, img: Image.Image,
                      mask: Image.Image, base_size: int = 513,
                      crop_size: int = 513, fill: int = 254):
    """imutils RandomScaleCrop (:306-340): short-side scale in
    [0.5, 2]*base, bottom/right pad (mask pad = fill), random crop."""
    short = int(rng.integers(int(base_size * 0.5), int(base_size * 2.0) + 1))
    w, h = img.size
    if h > w:
        ow, oh = short, int(1.0 * h * short / w)
    else:
        oh, ow = short, int(1.0 * w * short / h)
    img = img.resize((ow, oh), Image.BILINEAR)
    mask = mask.resize((ow, oh), Image.NEAREST)
    if short < crop_size:
        padh = crop_size - oh if oh < crop_size else 0
        padw = crop_size - ow if ow < crop_size else 0
        img = ImageOps.expand(img, border=(0, 0, padw, padh), fill=0)
        mask = ImageOps.expand(mask, border=(0, 0, padw, padh), fill=fill)
    w, h = img.size
    x1 = int(rng.integers(0, w - crop_size + 1))
    y1 = int(rng.integers(0, h - crop_size + 1))
    box = (x1, y1, x1 + crop_size, y1 + crop_size)
    return img.crop(box), mask.crop(box)


def hwc_to_chw(img: np.ndarray) -> np.ndarray:
    """imutils HWC_to_CHW / HWC_to_CHW_VAL (:290-295)."""
    return np.transpose(img, (2, 0, 1))


# ---------------------------------------------------------------------------
# CRF wrappers (imutils.py:345-402) on the native C++ lattice
# ---------------------------------------------------------------------------
def _meanfield(img: np.ndarray, unary_probs: np.ndarray, t: int,
               pos_xy: float, pos_w: float, bi_xy: float, bi_rgb: float,
               bi_w: float) -> np.ndarray:
    """Host mean-field in pydensecrf's parameterization (sxy, srgb,
    compat): normalized Gaussian and bilateral messages, the bilateral one
    on the native lattice, then the softmax update. img (H, W, 3),
    unary_probs (H, W, C) -> Q (H, W, C)."""
    from cosa_tpu_torch.eval.crf import _np_spatial_filter
    from cosa_tpu_torch.native.build import lattice_gaussian_cpu

    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    feats = np.concatenate(
        [(xs / bi_xy)[..., None], (ys / bi_xy)[..., None],
         img.astype(np.float32) / bi_rgb], axis=-1,
    ).reshape(-1, 5)

    def bilateral(qmap):
        return lattice_gaussian_cpu(feats, qmap.reshape(h * w, -1)).reshape(h, w, -1)

    def spatial(qmap):
        return _np_spatial_filter(qmap, pos_xy)

    def make_normalized(filter_fn):
        # the filter(1) normalization does not change across iterations
        norm = filter_fn(np.ones((h, w, 1), np.float32))
        inv = np.where(norm > 1e-20, 1.0 / np.sqrt(norm), 0.0)
        return lambda q: filter_fn(q * inv) * inv

    spatial_n = make_normalized(spatial)
    bilateral_n = make_normalized(bilateral)

    log_p = np.log(np.clip(unary_probs, 1e-8, 1.0))
    q = unary_probs.astype(np.float32)
    for _ in range(int(t)):
        logits = log_p + pos_w * spatial_n(q) + bi_w * bilateral_n(q)
        logits -= logits.max(axis=-1, keepdims=True)
        e = np.exp(logits)
        q = e / e.sum(axis=-1, keepdims=True)
    return q


def crf_inference(img: np.ndarray, probs: np.ndarray, t: int = 10,
                  scale_factor: float = 1, labels: int = 21) -> np.ndarray:
    """imutils crf_inference (:345-365): pos sxy 3 compat 3, bilateral
    sxy 80 srgb 13 compat 10. probs: (C, H, W) softmax; returns (C, H, W) Q."""
    q = _meanfield(img, np.moveaxis(probs, 0, -1), t,
                   pos_xy=3 / scale_factor, pos_w=3,
                   bi_xy=80 / scale_factor, bi_rgb=13, bi_w=10)
    return np.moveaxis(q, -1, 0)


def crf_inference_inf(img: np.ndarray, probs: np.ndarray, t: int = 10,
                      scale_factor: float = 1, labels: int = 21) -> np.ndarray:
    """imutils crf_inference_inf (:367-387): bilateral sxy 83 srgb 5 compat 4."""
    q = _meanfield(img, np.moveaxis(probs, 0, -1), t,
                   pos_xy=3 / scale_factor, pos_w=3,
                   bi_xy=83 / scale_factor, bi_rgb=5, bi_w=4)
    return np.moveaxis(q, -1, 0)


def crf_inference_label(img: np.ndarray, labels: np.ndarray, t: int = 10,
                        n_labels: int = 21, gt_prob: float = 0.7) -> np.ndarray:
    """imutils crf_inference_label (:389-402): label-seeded unary
    (pydensecrf unary_from_labels, zero_unsure=False), bilateral sxy 50
    srgb 5 compat 10; returns the refined (H, W) argmax labels."""
    h, w = img.shape[:2]
    u = np.full((h, w, n_labels), (1.0 - gt_prob) / (n_labels - 1), np.float32)
    np.put_along_axis(u, labels.astype(np.int64)[..., None], gt_prob, axis=-1)
    q = _meanfield(img, u, t, pos_xy=3, pos_w=3,
                   bi_xy=50, bi_rgb=5, bi_w=10)
    return np.argmax(q, axis=-1)
