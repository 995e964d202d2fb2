"""Datasets: VOC12, COCO, and a synthetic stand-in.

Twins of reference dataloaders/voc.py / coco.py (the live classes:
VOC12ClsDatasetNew voc.py:219-305, VOC12SegDataset voc.py:307-369, COCO
equivalents coco.py). Samples are plain numpy dicts; normalization happens
on device.

Directory layout expected (same as the reference README):
  VOC12:  {root}/JPEGImages/*.jpg, {root}/SegmentationClassAug/*.png
  COCO:   {root}/{train,val}2014/*.jpg, {root}/SegmentationClass/{split}2014/*.png

The COCO class-label dict (cls_labels_onehot.npy) is a missing large blob in
the reference checkout; when absent we derive image-level labels from the
segmentation masks on first access and cache them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from cosa_tpu_torch.data import randaug, transforms

# The split lists and label dicts are data files that live beside the JAX
# package (cosa_tpu/data/splits); they are read as files, never imported.
# ``--split_dir`` points at another copy.
_SPLIT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "cosa_tpu", "data", "splits",
)

VOC_CLASSES = [
    "_background_", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

COCO_CLASSES = [
    "_background_", "person", "bicycle", "car", "motorcycle", "airplane",
    "bus", "train", "truck", "boat", "traffic light", "fire hydrant",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv", "laptop",
    "mouse", "remote", "keyboard", "cell phone", "microwave", "oven",
    "toaster", "sink", "refrigerator", "book", "clock", "vase", "scissors",
    "teddy bear", "hair drier", "toothbrush",
]


def load_name_list(dataset: str, split: str, split_dir: str = "") -> List[str]:
    path = os.path.join(split_dir or _SPLIT_DIR, dataset, split + ".txt")
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def class_list(dataset: str, split_dir: str = "") -> List[str]:
    """Class names for tables/visualization. A custom split_dir may carry a
    ``class_names.txt`` override (one name per line) — used by the ShapesWSSS
    synthetic data, which rides the VOC pipeline with its own classes."""
    if split_dir:
        sub = "coco" if dataset == "COCO" else "voc"
        path = os.path.join(split_dir, sub, "class_names.txt")
        if os.path.exists(path):
            with open(path) as f:
                return [ln.strip() for ln in f if ln.strip()]
    return COCO_CLASSES if dataset == "COCO" else VOC_CLASSES


def _onehot_from_mask(mask: np.ndarray, num_classes: int, ignore: int) -> np.ndarray:
    ids = np.unique(mask).astype(np.int32)
    ids = ids[(ids != ignore) & (ids != 0)]
    onehot = np.zeros((num_classes,), np.uint8)
    onehot[ids] = 1
    return onehot


class _BaseDataset:
    """Raw (name, image, label) access (reference VOC12Dataset voc.py:43-81)."""

    dataset: str

    def __init__(self, root: str, split: str, stage: str, ignore_index: int = 255,
                 split_dir: str = ""):
        self.root = root
        self.split = split
        self.stage = stage
        self.ignore_index = ignore_index
        self.split_dir = split_dir or _SPLIT_DIR
        self.names = load_name_list(
            "voc" if self.dataset == "VOC12" else "coco", split, self.split_dir
        )

    def __len__(self) -> int:
        return len(self.names)

    def _paths(self, name: str) -> Tuple[str, str]:
        raise NotImplementedError

    def raw(self, idx: int, want_label: bool = True
            ) -> Tuple[str, np.ndarray, Optional[np.ndarray]]:
        """``want_label=False`` skips the mask read — the training pipeline
        only uses image-level labels (reference VOC12ClsDatasetNew never
        opens SegmentationClassAug), so per-sample mask IO would be pure
        waste and would wrongly require masks for every training image."""
        name = self.names[idx]
        img_path, lab_path = self._paths(name)
        image = np.asarray(Image.open(img_path).convert("RGB"))
        label = None
        if want_label and self.stage in ("train", "val"):
            label = np.asarray(Image.open(lab_path))
        elif want_label and self.stage == "test":
            label = image[:, :, 0]
        return name, image, label


class VOCBase(_BaseDataset):
    dataset = "VOC12"
    num_classes = 21

    def _paths(self, name):
        img_dir = "JPEGImages_test" if self.split == "test" else "JPEGImages"
        return (
            os.path.join(self.root, img_dir, name + ".jpg"),
            os.path.join(self.root, "SegmentationClassAug", name + ".png"),
        )


class COCOBase(_BaseDataset):
    dataset = "COCO"
    num_classes = 81

    def _paths(self, name):
        sp = "val" if self.split.startswith("val") else "train"
        return (
            os.path.join(self.root, sp + "2014", name + ".jpg"),
            os.path.join(self.root, "SegmentationClass", sp + "2014", name + ".png"),
        )


class _LabelDict:
    """Image-level one-hot labels from the split dir's cls_labels_onehot.npy
    (the reference loads this dict for BOTH datasets: voc.py:41, coco.py:22).
    The reference's COCO copy is a missing large blob in this environment, so
    when the file is absent the labels are derived lazily from the masks —
    the same information the blob encodes."""

    def __init__(self, base: _BaseDataset):
        self.base = base
        self.table: Dict[str, np.ndarray] = {}
        sdir = getattr(base, "split_dir", _SPLIT_DIR)
        sub = "voc" if base.dataset == "VOC12" else "coco"
        path = os.path.join(sdir, sub, "cls_labels_onehot.npy")
        if base.dataset == "VOC12" or os.path.exists(path):
            self.table = np.load(path, allow_pickle=True).item()

    def __call__(self, name: str, idx: int) -> np.ndarray:
        if name in self.table:
            return np.asarray(self.table[name], np.float32)
        _, _, mask = self.base.raw(idx)
        onehot = _onehot_from_mask(
            mask, self.base.num_classes, self.base.ignore_index
        )[1:]
        self.table[name] = onehot
        return np.asarray(onehot, np.float32)


class ClsTrainDataset:
    """Training samples (reference VOC12ClsDatasetNew voc.py:219-305):
    scale -> flip -> crop(448, img_box) -> blur; weak = as-is, strong =
    one RandAug op. Emits uint8 images; normalization is on device."""

    def __init__(
        self,
        base: _BaseDataset,
        crop_size: int = 448,
        rescale_range=(0.5, 2.0),
        seed: int = 0,
    ):
        self.base = base
        self.crop_size = crop_size
        self.rescale_range = tuple(rescale_range)
        self.labels = _LabelDict(base)
        self.seed = seed

    def __len__(self):
        return len(self.base)

    def __getitem__(self, key) -> Dict[str, np.ndarray]:
        """key: (epoch, idx) or idx. The rng is derived from (seed, epoch,
        idx) so any sample is replayable."""
        epoch, idx = key if isinstance(key, tuple) else (0, key)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx])
        )
        name, image, _ = self.base.raw(idx, want_label=False)
        image = transforms.random_scaling(rng, image, scale_range=self.rescale_range)
        image = transforms.random_fliplr(rng, image)
        image, img_box = transforms.random_crop(
            rng, image, crop_size=self.crop_size, mean_rgb=(0, 0, 0),
            ignore_index=self.base.ignore_index,
        )
        pil = Image.fromarray(np.ascontiguousarray(image))
        pil = transforms.gaussian_blur(rng, pil, p=0.5)
        weak = np.asarray(pil, np.uint8)
        strong = np.asarray(randaug.one_of(rng, pil), np.uint8)
        return dict(
            name=name,
            wimg=weak,
            simg=strong,
            cls_label=self.labels(name, idx),
            img_box=img_box,
        )


class ClsMultiCropDataset:
    """DINO-style multi-crop training samples (reference VOC12ClsDataset
    voc.py:84-218, unused in the live path). With ``aug=True`` each sample
    carries three views of one image:

      crops[0] = global view 1: scale/flip/crop(+img_box) -> flip+jitter
                 +grayscale -> blur(p=1)           (voc.py:131-137,166-169)
      crops[1] = global view 2: RandomResizedCrop(crop, [0.4,1], bicubic)
                 -> flip+jitter+grayscale -> blur(p=.1) -> solarize(p=.2)
                 on the UNCROPPED image             (voc.py:138-143,207)
      crops[2] = local view: flip+jitter+grayscale -> blur(p=.5) on the
                 cropped image (the RandomResizedCrop is commented out in
                 the reference, voc.py:145-149)

    Emits uint8 (device-side normalization), like the live datasets."""

    def __init__(self, base: _BaseDataset, crop_size: int = 512,
                 rescale_range=(0.5, 2.0), aug: bool = True, seed: int = 0):
        self.base = base
        self.crop_size = crop_size
        self.rescale_range = tuple(rescale_range) if rescale_range else None
        self.aug = aug
        self.labels = _LabelDict(base)
        self.seed = seed

    def __len__(self):
        return len(self.base)

    def _flip_jitter_gray(self, rng, pil):
        if rng.random() < 0.5:
            pil = pil.transpose(Image.FLIP_LEFT_RIGHT)
        if rng.random() < 0.8:
            pil = transforms.color_jitter(rng, pil)
        return transforms.random_grayscale(rng, pil, p=0.2)

    def __getitem__(self, key) -> Dict[str, np.ndarray]:
        epoch, idx = key if isinstance(key, tuple) else (0, key)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx, 7])
        )
        name, image, _ = self.base.raw(idx, want_label=False)
        cls_label = self.labels(name, idx)
        if not self.aug:
            return dict(name=name, image=np.asarray(image, np.uint8),
                        cls_label=cls_label)
        orig = Image.fromarray(np.ascontiguousarray(image))
        if self.rescale_range:
            image = transforms.random_scaling(
                rng, image, scale_range=self.rescale_range)
        image = transforms.random_fliplr(rng, image)
        image, img_box = transforms.random_crop(
            rng, image, crop_size=self.crop_size, mean_rgb=(0, 0, 0),
            ignore_index=self.base.ignore_index,
        )
        cropped = Image.fromarray(np.ascontiguousarray(image))

        g1 = transforms.gaussian_blur(
            rng, self._flip_jitter_gray(rng, cropped), p=1.0)
        g2 = transforms.random_resized_crop(rng, orig, self.crop_size)
        g2 = transforms.gaussian_blur(rng, self._flip_jitter_gray(rng, g2),
                                      p=0.1)
        g2 = transforms.solarization(rng, g2, p=0.2)
        local = transforms.gaussian_blur(
            rng, self._flip_jitter_gray(rng, cropped), p=0.5)

        g1 = np.asarray(g1, np.uint8)
        return dict(
            name=name, image=g1, cls_label=cls_label, img_box=img_box,
            crops=[g1, np.asarray(g2, np.uint8), np.asarray(local, np.uint8)],
        )


class SegTrainDataset:
    """Supervised-seg training samples (reference VOC12SegDatasetNew
    voc.py:371-443, unused in the live path): the ClsTrainDataset pipeline
    with the GT mask carried through scale/flip/crop — returns
    (name, weak, strong, cls_label, img_box, label)."""

    def __init__(self, base: _BaseDataset, crop_size: int = 448,
                 rescale_range=(0.5, 2.0), seed: int = 0):
        self.base = base
        self.crop_size = crop_size
        self.rescale_range = tuple(rescale_range)
        self.labels = _LabelDict(base)
        self.seed = seed

    def __len__(self):
        return len(self.base)

    def __getitem__(self, key) -> Dict[str, np.ndarray]:
        epoch, idx = key if isinstance(key, tuple) else (0, key)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx, 11])
        )
        name, image, label = self.base.raw(idx)
        image, label = transforms.random_scaling(
            rng, image, label=label, scale_range=self.rescale_range)
        image, label = transforms.random_fliplr(rng, image, label=label)
        image, label, img_box = transforms.random_crop(
            rng, image, label=label, crop_size=self.crop_size,
            mean_rgb=(0, 0, 0), ignore_index=self.base.ignore_index,
        )
        pil = Image.fromarray(np.ascontiguousarray(image))
        pil = transforms.gaussian_blur(rng, pil, p=0.5)
        weak = np.asarray(pil, np.uint8)
        strong = np.asarray(randaug.one_of(rng, pil), np.uint8)
        return dict(
            name=name, wimg=weak, simg=strong,
            cls_label=self.labels(name, idx), img_box=img_box,
            label=np.asarray(label, np.uint8),
        )


class SegValDataset:
    """Validation samples (reference VOC12SegDataset voc.py:307-369, aug off):
    raw-size uint8 image + GT mask + image-level labels.

    On the ground-truth-less ``test`` split (VOC eval-server submission,
    reference dataloaders/voc.py test list of 1456 images) the label is a
    zero canvas and the image-level vector is all-ones, which turns
    class-validation into a no-op — predictions come from the raw seg head.
    """

    def __init__(self, base: _BaseDataset):
        self.base = base
        self.labels = _LabelDict(base)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        name, image, label = self.base.raw(idx)
        if self.base.stage == "test":
            return dict(
                name=name,
                image=np.asarray(image, np.uint8),
                label=np.zeros(image.shape[:2], np.uint8),
                cls_label=np.ones((self.base.num_classes - 1,), np.float32),
            )
        return dict(
            name=name,
            image=np.asarray(image, np.uint8),
            label=np.asarray(label, np.uint8),
            cls_label=self.labels(name, idx),
        )


# ---------------------------------------------------------------------------
# synthetic data: colored class blobs on textured background — lets every
# train/eval path run (and the benchmark feed) without VOC/COCO on disk.
# ---------------------------------------------------------------------------
class SyntheticBase:
    dataset = "synthetic"

    def __init__(self, num_classes=21, size=(320, 400), length=256,
                 ignore_index=255, seed=1234, split="val", stage="val"):
        self.split = split
        self.stage = stage
        self.num_classes = num_classes
        self.size = size
        self.length = length
        self.ignore_index = ignore_index
        self.seed = seed
        rng = np.random.default_rng(seed)
        self.palette = rng.integers(30, 226, size=(num_classes, 3))

    def __len__(self):
        return self.length

    def raw(self, idx: int, want_label: bool = True):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, idx]))
        h = int(self.size[0] * rng.uniform(0.8, 1.2))
        w = int(self.size[1] * rng.uniform(0.8, 1.2))
        img = rng.integers(80, 176, size=(h, w, 3)).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            c = int(rng.integers(1, self.num_classes))
            bh, bw = int(h * rng.uniform(0.2, 0.5)), int(w * rng.uniform(0.2, 0.5))
            y0, x0 = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
            img[y0 : y0 + bh, x0 : x0 + bw] = self.palette[c] + rng.integers(
                -20, 21, size=(bh, bw, 3)
            ).clip(-min(30, int(self.palette[c].min())), 29)
            mask[y0 : y0 + bh, x0 : x0 + bw] = c
        return f"synth_{idx:05d}", img, mask


def build_base(cfg, split: str, stage: str) -> _BaseDataset:
    sdir = getattr(cfg, "split_dir", "")
    if cfg.dataset == "VOC12":
        return VOCBase(cfg.data_root, split, stage, cfg.ignore_index, sdir)
    if cfg.dataset == "COCO":
        return COCOBase(cfg.data_root, split, stage, cfg.ignore_index, sdir)
    if cfg.dataset == "synthetic":
        return SyntheticBase(cfg.num_classes, ignore_index=cfg.ignore_index,
                             split=split, stage=stage)
    raise NotImplementedError(cfg.dataset)
