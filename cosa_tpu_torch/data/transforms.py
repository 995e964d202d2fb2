"""Host-side geometric/photometric transforms (numpy + PIL).

Twins of reference dataloaders/transforms.py:9-203. Design difference: the
pipeline emits uint8 HWC crops and ImageNet normalization happens on device
inside the compiled step (cosa_tpu_torch/ops/image.py) — the reference ships f32
CHW tensors from a single worker (dataloaders/__init__.py:99).

Randomness: every function takes a ``numpy.random.Generator`` explicitly, so
a loader worker's stream is reproducible from (seed, epoch, index) — the
reference's implicit global random state cannot be replayed (SURVEY §7.3).
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter


def random_scaling(
    rng: np.random.Generator,
    image: np.ndarray,
    label: Optional[np.ndarray] = None,
    scale_range: Tuple[float, float] = (0.5, 2.0),
):
    """Uniform scale in [lo, hi]; PIL bilinear for image, nearest for label
    (reference transforms.py:52-77)."""
    ratio = rng.uniform(scale_range[0], scale_range[1])
    h, w = image.shape[:2]
    new = (int(ratio * w), int(ratio * h))  # PIL size is (W, H)
    img = Image.fromarray(image.astype(np.uint8)).resize(new, Image.BILINEAR)
    img = np.asarray(img)
    if label is None:
        return img
    lab = Image.fromarray(label).resize(new, Image.NEAREST)
    return img, np.asarray(lab)


def random_fliplr(
    rng: np.random.Generator,
    image: np.ndarray,
    label: Optional[np.ndarray] = None,
):
    flip = rng.random() > 0.5
    if label is None:
        return np.fliplr(image) if flip else image
    if flip:
        return np.fliplr(image), np.fliplr(label)
    return image, label


def random_crop(
    rng: np.random.Generator,
    image: np.ndarray,
    label: Optional[np.ndarray] = None,
    crop_size: int = 448,
    mean_rgb=(0, 0, 0),
    ignore_index: int = 255,
    cat_max_ratio: float = 0.75,
):
    """Pad to >= crop_size, take a random crop, return the valid-pixel
    rectangle ``img_box`` = [h0, h1, w0, w1] (reference transforms.py:145-202;
    img_box math :184-196). With a label, re-draws the crop up to 10x until
    no class dominates more than ``cat_max_ratio``."""
    h, w = image.shape[:2]
    H, W = max(crop_size, h), max(crop_size, w)

    pad_image = np.empty((H, W, 3), dtype=np.uint8)
    pad_image[..., 0] = mean_rgb[0]
    pad_image[..., 1] = mean_rgb[1]
    pad_image[..., 2] = mean_rgb[2]
    h_pad = int(rng.integers(0, H - h + 1))
    w_pad = int(rng.integers(0, W - w + 1))
    pad_image[h_pad : h_pad + h, w_pad : w_pad + w] = image.astype(np.uint8)

    def draw():
        hs = int(rng.integers(0, H - crop_size + 1))
        ws = int(rng.integers(0, W - crop_size + 1))
        return hs, ws

    hs, ws = draw()
    if label is not None:
        pad_label = np.full((H, W), ignore_index, dtype=np.uint8)
        pad_label[h_pad : h_pad + h, w_pad : w_pad + w] = label
        for _ in range(10):
            temp = pad_label[hs : hs + crop_size, ws : ws + crop_size]
            idx, cnt = np.unique(temp, return_counts=True)
            cnt = cnt[idx != ignore_index]
            if len(cnt) > 1 and cnt.max() / cnt.sum() < cat_max_ratio:
                break
            hs, ws = draw()

    crop = pad_image[hs : hs + crop_size, ws : ws + crop_size]
    img_box = np.array(
        [
            max(h_pad - hs, 0),
            min(crop_size, h + h_pad - hs),
            max(w_pad - ws, 0),
            min(crop_size, w + w_pad - ws),
        ],
        dtype=np.int32,
    )
    if label is None:
        return crop, img_box
    lab = pad_label[hs : hs + crop_size, ws : ws + crop_size]
    return crop, lab, img_box


def _rgb_to_hsv(img: np.ndarray):
    """uint8 RGB -> (h in [0,180), s in [0,255], v in [0,255]) float32,
    OpenCV-convention (what mmcv.bgr2hsv produces in the reference)."""
    rgb = img.astype(np.float32) / 255.0
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    h = np.where(
        mx == r, (g - b) / diff % 6.0,
        np.where(mx == g, (b - r) / diff + 2.0, (r - g) / diff + 4.0),
    )
    h = h * 30.0  # 0..180 like OpenCV uint8 hue
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0) * 255.0
    v = mx * 255.0
    return h, s, v


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    h = (h / 30.0) % 6.0
    s = np.clip(s / 255.0, 0, 1)
    v = np.clip(v / 255.0, 0, 1)
    i = np.floor(h).astype(int)
    f = h - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    lut = np.stack([
        np.stack([v, t, p], -1), np.stack([q, v, p], -1),
        np.stack([p, v, t], -1), np.stack([p, q, v], -1),
        np.stack([t, p, v], -1), np.stack([v, p, q], -1),
    ])
    rgb = np.take_along_axis(lut, i[None, ..., None] % 6, axis=0)[0]
    return np.clip(rgb * 255.0, 0, 255).astype(np.uint8)


class PhotoMetricDistortion:
    """mmseg-style photometric jitter (reference transforms.py:204-301):
    random brightness/contrast/saturation/hue, mmcv-free."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast = contrast_range
        self.saturation = saturation_range
        self.hue_delta = hue_delta

    @staticmethod
    def _convert(img, alpha=1.0, beta=0.0):
        return np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(
            np.uint8
        )

    def __call__(self, rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
        if rng.integers(2):
            img = self._convert(
                img, beta=rng.uniform(-self.brightness_delta, self.brightness_delta)
            )
        mode = int(rng.integers(2))
        if mode == 1 and rng.integers(2):
            img = self._convert(img, alpha=rng.uniform(*self.contrast))
        if rng.integers(2):
            h, s, v = _rgb_to_hsv(img)
            s = self._convert(s, alpha=rng.uniform(*self.saturation))
            img = _hsv_to_rgb(h, s, v)
        if rng.integers(2):
            h, s, v = _rgb_to_hsv(img)
            h = (h + rng.integers(-self.hue_delta, self.hue_delta)) % 180.0
            img = _hsv_to_rgb(h, s, v)
        if mode == 0 and rng.integers(2):
            img = self._convert(img, alpha=rng.uniform(*self.contrast))
        return img


def solarization(rng: np.random.Generator, img: Image.Image,
                 p: float = 0.2, threshold: int = 128) -> Image.Image:
    """Reference transforms.py Solarization (ImageOps.solarize with prob)."""
    if rng.random() > p:
        return img
    from PIL import ImageOps

    return ImageOps.solarize(img, threshold)


def color_jitter(rng: np.random.Generator, img: Image.Image,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.2, hue: float = 0.1) -> Image.Image:
    """torchvision ColorJitter semantics (used by the reference's DINO-style
    VOC12ClsDataset, voc.py:122-128): the four adjustments in a random
    order, factors uniform in [max(0, 1-x), 1+x] (hue in [-h, h])."""
    ops = list(rng.permutation(4))
    for op in ops:
        if op == 0 and brightness > 0:
            f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
            img = ImageEnhance.Brightness(img).enhance(f)
        elif op == 1 and contrast > 0:
            f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
            img = ImageEnhance.Contrast(img).enhance(f)
        elif op == 2 and saturation > 0:
            f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
            img = ImageEnhance.Color(img).enhance(f)
        elif op == 3 and hue > 0:
            f = rng.uniform(-hue, hue)
            h, s, v = _rgb_to_hsv(np.asarray(img))
            h = (h + f * 180.0) % 180.0  # full circle = 180 OpenCV units
            img = Image.fromarray(_hsv_to_rgb(h, s, v))
    return img


def random_grayscale(rng: np.random.Generator, img: Image.Image,
                     p: float = 0.2) -> Image.Image:
    """torchvision RandomGrayscale: ITU-R 601-2 luma replicated to 3ch."""
    if rng.random() > p:
        return img
    return img.convert("L").convert("RGB")


def random_resized_crop(
    rng: np.random.Generator,
    img: Image.Image,
    size: int,
    scale: Tuple[float, float] = (0.4, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Image.Image:
    """torchvision RandomResizedCrop (bicubic, as the reference's
    global_view2/local_view use): 10 attempts at a (scale-uniform area,
    log-uniform aspect) crop, else the torchvision center-crop fallback."""
    w, h = img.size
    area = h * w
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target = area * rng.uniform(scale[0], scale[1])
        ar = float(np.exp(rng.uniform(*log_ratio)))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return img.resize((size, size), Image.BICUBIC,
                              box=(x0, y0, x0 + cw, y0 + ch))
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return img.resize((size, size), Image.BICUBIC,
                      box=(x0, y0, x0 + cw, y0 + ch))


def gaussian_blur(
    rng: np.random.Generator,
    img: Image.Image,
    p: float = 0.5,
    radius_min: float = 0.1,
    radius_max: float = 2.0,
) -> Image.Image:
    """Reference transforms.py:9-27."""
    if rng.random() > p:
        return img
    return img.filter(
        ImageFilter.GaussianBlur(radius=rng.uniform(radius_min, radius_max))
    )
