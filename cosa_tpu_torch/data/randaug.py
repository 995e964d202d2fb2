"""Strong augmentation: one-of-9 RandAug ops (reference dataloaders/randaug.py).

Each op fires with prob 1 and a random magnitude in {1..9}; ``one_of`` picks
a single op per sample (reference randaug.py:21-130, wired at voc.py:253-262).
mmcv.solarize(img, thr) == PIL ImageOps.solarize at the same threshold, so no
mmcv dependency is needed.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

PARAMETER_MAX = 10


def _int_param(level: int, maxval: int) -> int:
    return int(level * maxval / PARAMETER_MAX)


def _float_param(level: int, maxval: float) -> float:
    return float(level) * maxval / PARAMETER_MAX


def _enhance(op):
    def f(img: Image.Image, mag: int) -> Image.Image:
        v = _float_param(mag, 1.8) + 0.1  # reference randaug.py:82-90
        return op(img).enhance(v)

    return f


def _identity(img, mag):
    return img


def _autocontrast(img, mag):
    return ImageOps.autocontrast(img)


def _equalize(img, mag):
    return ImageOps.equalize(img)


def _solarize(img, mag):
    return ImageOps.solarize(img, min(_int_param(mag, 256), 255))


def _posterize(img, mag):
    return ImageOps.posterize(img, 4 - _int_param(mag, 4))


OPS = (
    _identity,
    _autocontrast,
    _equalize,
    _solarize,
    _enhance(ImageEnhance.Color),
    _enhance(ImageEnhance.Contrast),
    _enhance(ImageEnhance.Brightness),
    _enhance(ImageEnhance.Sharpness),
    _posterize,
)


def one_of(rng: np.random.Generator, img: Image.Image) -> Image.Image:
    """Apply one randomly chosen op at magnitude ~ U{1..9}
    (reference randaug.py:43-49, 123-129)."""
    op = OPS[int(rng.integers(0, len(OPS)))]
    mag = int(rng.integers(1, PARAMETER_MAX))
    return op(img, mag)
