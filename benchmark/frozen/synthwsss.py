"""Frozen copy of the program's ShapesWSSS generator
(``cosa_tpu_torch/data/synthwsss.py``), kept here so that the benchmark's
data stays the same whatever a later change does to the program. It
imports only numpy and PIL. The original's docstring follows.

ShapesWSSS: a procedurally generated, *solvable* weakly-supervised
segmentation task, built entirely in-environment.

The port's own copy of the JAX package's data/synthwsss.py (numpy only;
it writes the same files, byte for byte).

Purpose (round-3 accuracy evidence): the reference's 76.2/51.0 mIoU targets
need VOC/COCO data + released weights that do not exist in this environment,
so the strongest available proxy is an end-to-end co-training run on a task
where weak supervision demonstrably works. This module generates such a task
in the exact VOC12 on-disk layout ({root}/JPEGImages/*.jpg,
{root}/SegmentationClassAug/*.png, {split_dir}/voc/{train_aug,val}.txt,
{split_dir}/voc/cls_labels_onehot.npy — reference dataloaders/voc.py:39-81),
so a training run exercises the UNMODIFIED VOC pipeline: ClsTrainDataset
augmentation, the co-training step, GMM thresholds, eval TTA, CRF — all of it.

A COCO-shaped variant (layout="coco", round 4) writes the reference's COCO
on-disk layout (train2014/val2014, SegmentationClass/val2014, train/val/
val_part splits, the coco cls_labels_onehot.npy dict of coco.py:22) with
80 fg classes = 20 hues x 4 texture families, so the 81-class COCO pipeline
(args_coco.py presets, val_part during-training eval) is exercised end to
end too.

Task design (solvable under image-level supervision, from-scratch ViT):
  * 20 foreground classes = 10 hues x 2 texture families (stripes / dots).
    Hue carries most of the class signal (36 deg spacing, +-9 deg jitter);
    texture doubles the class count and adds intra-class variance.
  * Each instance: a random SHAPE (shape is NOT class-informative) —
    circle / ellipse / rectangle / diamond / triangle / 5-star / ring —
    random size (22-45% of the short side), rotation, saturation, value.
  * Cluttered background: low-saturation base with smooth gradients +
    low-frequency noise + 3-6 *desaturated distractor shapes* that reuse the
    same shapes and textures — so "any shape" or "any texture" is not enough;
    only saturated class hues mark foreground.
  * 1-3 foreground instances per image (distinct classes), later objects
    occlude earlier ones; masks record visible pixels.
  * GT masks are WITHHELD from training: only val-split masks are written to
    disk; image-level labels come from the cls_labels_onehot.npy dict
    (the training path never opens SegmentationClassAug — datasets.py raw()).
  * Saved val masks carry a 2px ignore (255) boundary ring like VOC's
    SegmentationClassAug void borders.

Everything is derived from `np.random.SeedSequence([seed, idx])` so any
sample is reproducible independently of generation order.
"""

from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

N_HUES = 10
N_TEXTURES = 2  # 0 = stripes, 1 = dots (VOC-shaped default)
N_FG = N_HUES * N_TEXTURES  # 20 fg classes -> num_classes=21 with background
SHAPES = ("circle", "ellipse", "rect", "diamond", "triangle", "star", "ring")
TEXTURE_NAMES = ("stripes", "dots", "checker", "rings")

# COCO-shaped variant: 20 hues x 4 texture families = 80 fg classes
# -> num_classes=81, matching the reference's COCO head
# (args_coco.py num_classes; dataloaders/coco.py class_list).
COCO_N_HUES = 20
COCO_N_TEXTURES = 4

CLASS_NAMES = ["_background_"] + [
    f"hue{h:02d}_{tex}" for tex in ("stripes", "dots") for h in range(N_HUES)
]


def class_names(n_hues: int = N_HUES, n_textures: int = N_TEXTURES):
    return ["_background_"] + [
        f"hue{h:02d}_{TEXTURE_NAMES[t]}"
        for t in range(n_textures) for h in range(n_hues)
    ]


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Vectorized HSV->RGB, h/s/v in [0,1], returns float RGB in [0,1]."""
    h = (h % 1.0) * 6.0
    i = np.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.choose(
        i[..., None],
        [
            np.stack([v, t, p], -1)[None],
            np.stack([q, v, p], -1)[None],
            np.stack([p, v, t], -1)[None],
            np.stack([p, q, v], -1)[None],
            np.stack([t, p, v], -1)[None],
            np.stack([v, p, q], -1)[None],
        ],
        mode="clip",
    )[0]
    return out


def _rot_coords(h: int, w: int, cy: float, cx: float, theta: float):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dy, dx = yy - cy, xx - cx
    c, s = np.cos(theta), np.sin(theta)
    return c * dy + s * dx, -s * dy + c * dx  # u (local y), v (local x)


def _shape_dist(kind: str, u: np.ndarray, v: np.ndarray, ry: float, rx: float
                ) -> np.ndarray:
    """Approximate signed distance (negative inside), normalized so the
    boundary is at 0 and |grad| ~ 1/r — enough for 1-2 px anti-aliasing."""
    if kind == "circle":
        rx = ry
    if kind in ("circle", "ellipse"):
        return np.sqrt((u / ry) ** 2 + (v / rx) ** 2) - 1.0
    if kind == "rect":
        return np.maximum(np.abs(u) / ry, np.abs(v) / rx) - 1.0
    if kind == "diamond":
        return np.abs(u) / ry + np.abs(v) / rx - 1.0
    rho = np.sqrt((u / ry) ** 2 + (v / rx) ** 2)
    phi = np.arctan2(v / rx, u / ry)
    if kind == "triangle":
        n = 3
        r = np.cos(np.pi / n) / np.cos((phi % (2 * np.pi / n)) - np.pi / n)
        return rho - r
    if kind == "star":
        n = 5
        frac = (phi % (2 * np.pi / n)) / (2 * np.pi / n)  # 0..1 within a point
        tri = 1.0 - 2.0 * np.abs(frac - 0.5)  # 1 at spike, 0 between
        r = 0.45 + 0.55 * tri
        return rho - r
    if kind == "ring":
        return np.maximum(rho - 1.0, 0.55 - rho)
    raise ValueError(kind)


def _texture_mod(tex: int, u: np.ndarray, v: np.ndarray, period: float,
                 psi: float, phase: float, strength: float) -> np.ndarray:
    """Multiplicative value modulation in [1-strength, 1+strength]."""
    if tex == 0:  # stripes: smooth sinusoidal bands along direction psi
        t = np.sin(2 * np.pi * (u * np.cos(psi) + v * np.sin(psi)) / period
                   + phase)
        return 1.0 + strength * t
    if tex == 1:
        # dots: dark discs on a rotated square lattice
        a = (u * np.cos(psi) + v * np.sin(psi)) / period + phase
        b = (-u * np.sin(psi) + v * np.cos(psi)) / period
        da = a - np.round(a)
        db = b - np.round(b)
        d = np.sqrt(da * da + db * db)  # 0 at lattice points, ~0.7 max
        inside = np.clip((0.30 - d) / 0.08, 0.0, 1.0)  # soft disc of radius .3
        return 1.0 - 2.0 * strength * inside
    if tex == 2:
        # checker: smooth product of two orthogonal sinusoids (sign pattern)
        a = (u * np.cos(psi) + v * np.sin(psi)) / period + phase
        b = (-u * np.sin(psi) + v * np.cos(psi)) / period
        t = np.sin(2 * np.pi * a) * np.sin(2 * np.pi * b)
        return 1.0 + 1.4 * strength * t
    if tex == 3:
        # rings: concentric bands around the instance center
        # (rotation-invariant; psi unused, phase shifts the radial bands)
        rho = np.sqrt(u * u + v * v)
        t = np.sin(2 * np.pi * rho / period + 2 * np.pi * phase)
        return 1.0 + strength * t
    raise ValueError(tex)


def _paint(img: np.ndarray, alpha: np.ndarray, rgb: np.ndarray) -> None:
    img *= (1.0 - alpha)[..., None]
    img += alpha[..., None] * rgb


def _lowres_noise(rng: np.random.Generator, h: int, w: int, cells: int = 9
                  ) -> np.ndarray:
    """Smooth value noise: coarse Gaussian grid, bilinear-upsampled."""
    gh, gw = cells, cells
    g = rng.normal(size=(gh, gw)).astype(np.float32)
    yi = np.linspace(0, gh - 1, h, dtype=np.float32)
    xi = np.linspace(0, gw - 1, w, dtype=np.float32)
    y0 = np.clip(yi.astype(np.int32), 0, gh - 2)
    x0 = np.clip(xi.astype(np.int32), 0, gw - 2)
    fy = (yi - y0)[:, None]
    fx = (xi - x0)[None, :]
    a = g[y0][:, x0]
    b = g[y0][:, x0 + 1]
    c = g[y0 + 1][:, x0]
    d = g[y0 + 1][:, x0 + 1]
    return a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx


def _draw_object(rng: np.random.Generator, img: np.ndarray,
                 mask: Optional[np.ndarray], class_id: int,
                 foreground: bool, n_hues: int = N_HUES,
                 n_textures: int = N_TEXTURES, fade: float = 1.0) -> None:
    """Render one shape instance into img (and mask when foreground)."""
    h, w = img.shape[:2]
    short = min(h, w)
    ry = short * rng.uniform(0.11, 0.225)  # half-extents: 22-45% diameter
    rx = ry * rng.uniform(0.7, 1.4)
    cy = rng.uniform(0.8 * ry, h - 0.8 * ry)
    cx = rng.uniform(0.8 * rx, w - 0.8 * rx)
    theta = rng.uniform(0, 2 * np.pi)
    kind = SHAPES[int(rng.integers(len(SHAPES)))]

    # bounding patch (shapes fit in the rotated ellipse of radius max(ry,rx))
    r = max(ry, rx) * 1.05
    y0, y1 = max(0, int(cy - r)), min(h, int(cy + r) + 1)
    x0, x1 = max(0, int(cx - r)), min(w, int(cx + r) + 1)
    if y1 <= y0 or x1 <= x0:
        return
    u, v = _rot_coords(y1 - y0, x1 - x0, cy - y0, cx - x0, theta)
    d = _shape_dist(kind, u, v, ry, rx)
    alpha = np.clip(0.5 - d * min(ry, rx) / 1.5, 0.0, 1.0)  # ~1.5px AA edge

    if foreground:
        hue_idx = (class_id - 1) % n_hues
        tex = (class_id - 1) // n_hues
        hue = (hue_idx + rng.uniform(-0.25, 0.25)) / n_hues
        # fade < 1 pulls the foreground toward the achromatic distractor
        # statistics (drifting-contrast regime for the GMM A/B): saturation
        # scales down and value compresses toward the 0.55 background mean
        sat = rng.uniform(0.65, 0.95) * fade
        val = 0.55 + (rng.uniform(0.5, 0.9) - 0.55) * (0.4 + 0.6 * fade)
    else:  # distractor: same shapes/textures, but (near-)achromatic
        tex = int(rng.integers(n_textures))
        hue = rng.uniform(0, 1)
        sat = rng.uniform(0.0, 0.15)
        val = rng.uniform(0.25, 0.85)

    period = rng.uniform(10.0, 18.0)
    mod = _texture_mod(tex, u, v, period, rng.uniform(0, 2 * np.pi),
                       rng.uniform(0, 1), strength=0.38)
    vmap = np.clip(val * mod, 0.04, 1.0).astype(np.float32)
    rgb = _hsv_to_rgb(np.full_like(vmap, hue), np.full_like(vmap, sat), vmap)
    _paint(img[y0:y1, x0:x1], alpha, rgb)
    if foreground and mask is not None:
        mask[y0:y1, x0:x1][alpha > 0.5] = class_id


def render_sample(seed: int, idx: int,
                  size_range: Tuple[int, int] = (352, 512),
                  n_hues: int = N_HUES, n_textures: int = N_TEXTURES,
                  fade_range: Optional[Tuple[float, float]] = None,
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render one sample -> (img u8 HxWx3, mask u8 HxW, onehot f32 (n_fg,)).

    Default (n_hues, n_textures) keeps the VOC-shaped task bit-identical to
    round 3 (same rng draw order); (20, 4) is the 80-fg-class COCO shape.

    ``fade_range=(lo, hi)``: the drifting-contrast regime (round 5, GMM
    fixed-vs-adaptive A/B). One per-image factor ~ U(lo, hi) scales every
    foreground instance's saturation and compresses its value contrast
    toward the background mean, so the image POPULATION spans crisp
    (fade~1) to faint (fade~lo) foregrounds. Faint images yield diffuse,
    low-peaked CAMs, which makes any single fixed (low, high) threshold
    pair wrong for part of the data — the regime adaptive GMM thresholds
    exist for (reference seg_helper.py:924-959). The extra rng draw only
    happens when fade_range is set, so default datasets stay bit-identical
    to rounds 3-4."""
    n_fg = n_hues * n_textures
    rng = np.random.default_rng(np.random.SeedSequence([seed, idx]))
    h = int(rng.integers(size_range[0], size_range[1] + 1))
    w = int(rng.integers(size_range[0], size_range[1] + 1))

    # --- cluttered background -------------------------------------------
    base_v = rng.uniform(0.35, 0.7)
    gdir = rng.uniform(0, 2 * np.pi)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    grad = ((yy / h) * np.cos(gdir) + (xx / w) * np.sin(gdir))
    vfield = base_v + 0.15 * (grad - grad.mean()) + 0.08 * _lowres_noise(rng, h, w)
    vfield = np.clip(vfield, 0.05, 0.95)
    bg_hue = rng.uniform(0, 1)
    bg_sat = rng.uniform(0.02, 0.18)
    img = _hsv_to_rgb(np.full_like(vfield, bg_hue),
                      np.full_like(vfield, bg_sat), vfield)

    # distractor shapes (under the foreground; never enter the mask)
    for _ in range(int(rng.integers(3, 7))):
        _draw_object(rng, img, None, 0, foreground=False,
                     n_hues=n_hues, n_textures=n_textures)

    # --- foreground instances -------------------------------------------
    mask = np.zeros((h, w), np.uint8)
    n_obj = int(rng.choice([1, 2, 3], p=[0.4, 0.4, 0.2]))
    classes = 1 + rng.choice(n_fg, size=n_obj, replace=False)
    fade = float(rng.uniform(*fade_range)) if fade_range is not None else 1.0
    for c in classes:
        _draw_object(rng, img, mask, int(c), foreground=True,
                     n_hues=n_hues, n_textures=n_textures, fade=fade)

    # pixel noise (sensor-ish) before the u8 quantize
    img += rng.normal(scale=0.012, size=img.shape).astype(np.float32)
    img_u8 = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)

    # occlusion can erase a class entirely; labels reflect VISIBLE classes
    present = np.unique(mask)
    onehot = np.zeros((n_fg,), np.float32)
    onehot[present[present > 0] - 1] = 1.0
    return img_u8, mask, onehot


def boundary_ignore(mask: np.ndarray, width: int = 2,
                    ignore: int = 255) -> np.ndarray:
    """Add an ignore ring on label boundaries (VOC void-border convention)."""
    edge = np.zeros_like(mask, bool)
    edge[:-1] |= mask[:-1] != mask[1:]
    edge[1:] |= mask[:-1] != mask[1:]
    edge[:, :-1] |= mask[:, :-1] != mask[:, 1:]
    edge[:, 1:] |= mask[:, :-1] != mask[:, 1:]
    grown = edge
    for _ in range(width - 1):
        g = grown.copy()
        g[:-1] |= grown[1:]
        g[1:] |= grown[:-1]
        g[:, :-1] |= grown[:, 1:]
        g[:, 1:] |= grown[:, :-1]
        grown = g
    out = mask.copy()
    out[grown] = ignore
    return out


# VOC-compatible palette for mask PNGs (bit-interleave, datasets.py palette)
def _voc_palette() -> bytes:
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        lab, shift = i, 7
        while lab:
            pal[i, 0] |= ((lab >> 0) & 1) << shift
            pal[i, 1] |= ((lab >> 1) & 1) << shift
            pal[i, 2] |= ((lab >> 2) & 1) << shift
            lab >>= 3
            shift -= 1
    return pal.tobytes()


POOL_MIN_SAMPLES = 256  # make_dataset's smallest tree to render in a process pool


def _write_sample(task) -> list:
    """Render sample ``idx`` and write its JPEG (and its val mask); return its
    one-hot label as a list (an array sent back from a worker process would
    bring a dtype object of its own, which the label file would pickle)."""
    from PIL import Image

    (root, split, idx, seed, size_range, n_hues, n_textures, fade_range, jpeg_quality,
     img_dir, seg_dir) = task
    name = f"synth_{idx:07d}"
    img, mask, onehot = render_sample(seed, idx, size_range, n_hues=n_hues,
                                      n_textures=n_textures, fade_range=fade_range)
    Image.fromarray(img).save(os.path.join(root, img_dir, name + ".jpg"), quality=jpeg_quality)
    if seg_dir is not None:
        m = Image.fromarray(boundary_ignore(mask), mode="P")
        m.putpalette(_voc_palette())
        m.save(os.path.join(root, seg_dir, name + ".png"))
    return onehot.tolist()


def make_dataset(root: str, n_train: int = 3000, n_val: int = 200,
                 seed: int = 0, jpeg_quality: int = 92,
                 size_range: Tuple[int, int] = (352, 512),
                 layout: str = "voc",
                 n_hues: Optional[int] = None,
                 n_textures: Optional[int] = None,
                 n_val_part: Optional[int] = None,
                 fade_range: Optional[Tuple[float, float]] = None,
                 ) -> Dict[str, int]:
    """Write the dataset in VOC12 or COCO on-disk layout under ``root``.

    Train masks are NOT written (weak supervision — the training pipeline
    never reads them anyway, datasets.py raw(want_label=False)); val masks
    get the boundary-ignore ring. Split lists + the image-level label dict
    go to {root}/splits/{voc,coco}/ so runs use
    ``--data_root {root} --split_dir {root}/splits``.

    layout="voc" (default): 20 fg classes, {root}/JPEGImages +
    SegmentationClassAug, splits train_aug/val — bit-identical to the
    round-3 generator. layout="coco": 80 fg classes (20 hues x 4 textures),
    {root}/{train,val}2014 + SegmentationClass/val2014, splits
    train/val/val_part (reference dataloaders/coco.py:38-44 layout; during-
    training eval uses val_part unless --valfull, dataloaders/__init__.py:25),
    and the image-level dict the reference loads at coco.py:22 (its real COCO
    copy is a missing large blob in this environment).

    A tree of ``POOL_MIN_SAMPLES`` samples or more is rendered and written
    by a pool of up to 8 processes (one per usable core); a smaller one, in
    this process, where a pool would cost more than it saves. The files are
    the same bytes either way.
    """
    assert layout in ("voc", "coco"), layout
    if n_hues is None:
        n_hues = N_HUES if layout == "voc" else COCO_N_HUES
    if n_textures is None:
        n_textures = N_TEXTURES if layout == "voc" else COCO_N_TEXTURES
    n_fg = n_hues * n_textures

    if layout == "voc":
        dirs = {"train_aug": "JPEGImages", "val": "JPEGImages"}
        seg_dirs = {"val": "SegmentationClassAug"}
        splits = (("train_aug", n_train, 0), ("val", n_val, 10**6))
        split_dir = os.path.join(root, "splits", "voc")
    else:
        dirs = {"train": "train2014", "val": "val2014"}
        seg_dirs = {"val": os.path.join("SegmentationClass", "val2014")}
        splits = (("train", n_train, 0), ("val", n_val, 10**6))
        split_dir = os.path.join(root, "splits", "coco")
    for d in set(dirs.values()) | set(seg_dirs.values()):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    os.makedirs(split_dir, exist_ok=True)

    labels: Dict[str, np.ndarray] = {}
    names: Dict[str, list] = {s: [] for s, _, _ in splits}
    counts = np.zeros(n_fg + 1, np.int64)
    tasks = [(root, split, base + k, seed, size_range, n_hues, n_textures, fade_range,
              jpeg_quality, dirs[split], seg_dirs.get(split))
             for split, n, base in splits for k in range(n)]
    workers = min(len(os.sched_getaffinity(0)), 8) if len(tasks) >= POOL_MIN_SAMPLES else 1
    if workers > 1:  # each sample is drawn from (seed, idx) alone: order-free
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            onehots = list(pool.map(_write_sample, tasks, chunksize=16))
    else:
        onehots = [_write_sample(t) for t in tasks]
    for (_, split, idx, *_), onehot in zip(tasks, onehots):
        name = f"synth_{idx:07d}"
        labels[name] = onehot = np.array(onehot, np.float32)
        names[split].append(name)
        counts[0] += 1
        counts[1:] += onehot.astype(np.int64)

    for split, lst in names.items():
        with open(os.path.join(split_dir, split + ".txt"), "w") as f:
            f.write("\n".join(lst) + "\n")
    if layout == "coco":  # during-training eval subset (reference val_part)
        part = names["val"][: (n_val_part or max(1, n_val // 2))]
        with open(os.path.join(split_dir, "val_part.txt"), "w") as f:
            f.write("\n".join(part) + "\n")
    np.save(os.path.join(split_dir, "cls_labels_onehot.npy"),
            np.array(labels, dtype=object), allow_pickle=True)
    meta = dict(
        n_train=n_train, n_val=n_val, seed=seed, num_classes=n_fg + 1,
        layout=layout, n_hues=n_hues, n_textures=n_textures,
        fade_range=list(fade_range) if fade_range else None,
        class_images=counts[1:].tolist(),
    )
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta
