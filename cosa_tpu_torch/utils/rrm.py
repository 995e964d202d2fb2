"""RRM-era legacy utilities (the JAX package's utils/rrm.py: reference
``utils/rrm_utils.py`` and the unique symbols of ``utils/helper.py``), which
the reference's live pipeline does not import:

  * dual-alpha CRF label fusion: :func:`crf_with_alpha`,
    :func:`compute_seg_label` (rrm_utils.py:9-79, with its empty-class
    guard) and the batched :func:`cam2seglabel` / :func:`compute_cam_up`
    (helper.py:109-125), on ``data/imutils.py::crf_inference`` (the native
    C++ lattice; a failed build raises);
  * the joint CE + dense-energy loss :func:`compute_joint_loss`
    (rrm_utils.py:82-120) on the step's own ``get_energy_loss``, so its RFF
    embedding is K3 on the card;
  * the prototype-contrast regularizer :func:`compute_cos` /
    :func:`compute_dis_no_batch` (rrm_utils.py:245-340);
  * data helpers (rrm_utils.py:130-242);
  * :func:`rrm_poly_sgd`, helper.py:182-209's two-phase PolyOptimizer with
    its weight_decay-into-the-momentum-slot positional bug.

Images and CAMs that cross the CRF are channel-first numpy (C, H, W), as in
the reference; the torch losses are NHWC like the rest of the port.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from cosa_tpu_torch.data.imutils import crf_inference
from cosa_tpu_torch.objectives.energy import get_energy_loss
from cosa_tpu_torch.objectives.losses import _per_pixel_nll
from cosa_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_ac


# ---------------------------------------------------------------------------
# Dual-alpha CRF label fusion (rrm_utils.py:9-79)
# ---------------------------------------------------------------------------

def crf_with_alpha(
    ori_img: np.ndarray,
    cam_dict: Dict[int, np.ndarray],
    alpha: float,
    n_classes: int = 21,
    t: int = 10,
) -> np.ndarray:
    """``_crf_with_alpha`` (rrm_utils.py:9-20): stack the present-class CAM
    planes, synthesize a background plane as (1 - max_fg)^alpha, run CRF
    mean-field over the compact (1+present) planes, then scatter the result
    back into a dense (n_classes, H, W) map (absent classes stay 0).

    ori_img: (H, W, 3) uint8 RGB. cam_dict: {fg_class_index: (H, W) cam}.
    """
    v = np.array(list(cam_dict.values()), dtype=np.float32)
    bg_score = np.power(1.0 - np.max(v, axis=0, keepdims=True), alpha)
    bgcam_score = np.concatenate((bg_score, v), axis=0)
    crf_score = crf_inference(ori_img, bgcam_score, t=t,
                              labels=bgcam_score.shape[0])

    dense = np.zeros((n_classes, bg_score.shape[1], bg_score.shape[2]),
                     dtype=crf_score.dtype)
    dense[0] = crf_score[0]
    for i, key in enumerate(cam_dict.keys()):
        dense[key + 1] = crf_score[i + 1]
    return dense


def compute_seg_label(
    ori_img: np.ndarray,
    cam_label: np.ndarray,
    norm_cam: np.ndarray,
    n_fg_classes: int = 20,
) -> np.ndarray:
    """``compute_seg_label`` (rrm_utils.py:23-79): fuse a low-alpha (4) and a
    high-alpha (32) CRF pass over the normalized CAMs into a pseudo mask with
    an ignore (255) band.

    Semantics, in order (all indices are 1-offset fg labels, 0 = background):
      * start from the low-alpha argmax; its *background* pixels become 255
        (low alpha under-grows background, so bg there is unreliable);
      * pixels the high-alpha pass calls background are forced to 0 (high
        alpha over-grows background, so its bg is reliable);
      * "not sure" pixels become 255: CRF confidence below 0.8 on the fused
        map (high-alpha bg plane + low-alpha fg planes), OR outside the
        per-class CAM "sure region" — for each fg class present in the
        low-alpha labels, the sure region is cam > 60th-percentile of that
        class's argmax-region values above 0.1 (empty region -> threshold 0,
        the rrm_utils.py:55-56 guard; helper.py:127-180's duplicate omits it
        and IndexErrors instead); for background, bg_score > 0.8.

    ori_img: (H, W, 3) uint8; cam_label: (n_fg,) image-level onehot;
    norm_cam: (n_fg, H, W) per-class min-max-normalized CAM. Returns
    (H, W) int pseudo label with 255 = ignore.
    """
    cam_label = cam_label.astype(np.uint8)
    cam_dict = {i: norm_cam[i] for i in range(n_fg_classes)
                if cam_label[i] > 1e-5}
    cam_np = np.zeros_like(norm_cam)
    for i in cam_dict:
        cam_np[i] = norm_cam[i]

    bg_score = np.power(1.0 - np.max(cam_np, 0), 32)[None]
    cam_all = np.concatenate((bg_score, cam_np))
    cam_img = np.argmax(cam_all, 0)

    crf_la = crf_with_alpha(ori_img, cam_dict, 4, n_classes=n_fg_classes + 1)
    crf_ha = crf_with_alpha(ori_img, cam_dict, 32, n_classes=n_fg_classes + 1)
    crf_la_label = np.argmax(crf_la, 0)
    crf_ha_label = np.argmax(crf_ha, 0)
    crf_label = crf_la_label.copy()
    crf_label[crf_la_label == 0] = 255

    cam_sure_region = np.zeros(bg_score.shape[1:], dtype=bool)
    for class_i in np.unique(crf_la_label):
        cam_class = np.where(cam_img == class_i, cam_all[class_i], 0.0)
        if class_i != 0:
            vals = np.sort(cam_class[cam_class > 0.1])
            confidence = vals[int(vals.shape[0] * 0.6)] if len(vals) else 0.0
            cam_sure_region |= cam_class > confidence
        else:
            cam_sure_region |= cam_class > 0.8

    crf_label[crf_ha_label == 0] = 0
    fused = np.concatenate([crf_ha[:1], crf_la[1:]])
    not_sure = (np.max(fused, 0) < 0.8) | ~cam_sure_region
    crf_label[not_sure] = 255
    return crf_label


def compute_cam_up(cam: torch.Tensor, label: torch.Tensor,
                   size_hw: Tuple[int, int]) -> np.ndarray:
    """``compute_cam_up`` (rrm_utils.py:123-127): the raw CAM bilinearly
    upsampled to the image size, absent classes zeroed. cam (B, h, w, n_fg)
    NHWC, label (B, n_fg) -> host numpy (B, H, W, n_fg)."""
    up = resize_bilinear(cam, size_hw) * label.to(cam.dtype)[:, None, None, :]
    return up.cpu().numpy()


def cam2seglabel(cam: torch.Tensor, label: torch.Tensor, ori_images: np.ndarray) -> np.ndarray:
    """``cam2seglabel`` (helper.py:109-119): each image's upsampled CAM
    max-normalized, then :func:`compute_seg_label`. cam (B, h, w, n_fg)
    NHWC, label (B, n_fg), ori_images (B, H, W, 3) uint8 -> (B, H, W) int32
    pseudo labels, on (H, W) axes throughout (the reference's transposed
    (W, H) sizing agrees only on its square crops)."""
    b, h, w = ori_images.shape[:3]
    cam_up = compute_cam_up(cam, label, (h, w))
    lab = label.cpu().numpy()
    out = np.zeros((b, h, w), dtype=np.int32)
    for i in range(b):
        norm = cam_up[i] / (cam_up[i].max(axis=(0, 1), keepdims=True) + 1e-5)
        out[i] = compute_seg_label(ori_images[i].astype(np.uint8), lab[i],
                                   np.moveaxis(norm, -1, 0), n_fg_classes=cam.shape[-1])
    return out


# ---------------------------------------------------------------------------
# Joint CE + dense-energy loss (rrm_utils.py:82-120)
# ---------------------------------------------------------------------------

def compute_joint_loss(images: torch.Tensor, seg_logits: torch.Tensor,
                       seg_label: torch.Tensor, croppings: torch.Tensor,
                       energy_weight: float = 1e-7, sigma_rgb: float = 15.0,
                       sigma_xy: float = 100.0, scale_factor: float = 0.5,
                       **energy_kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
    """``compute_joint_loss`` (rrm_utils.py:82-120): background CE plus
    foreground CE (each over its own pixel count, added whole, not the live
    seg_loss's 0.5/0.5 blend) and the dense-energy regularizer gated by the
    crop mask.

    images (B, H, W, 3) normalized NHWC; seg_logits (B, h, w, C), resized to
    the labels' size; seg_label (B, H, W) with 255 ignore; croppings
    (B, H, W), 1 on in-crop pixels. The crop mask reaches the energy as its
    bounding box, exact for rrm's rectangular masks (rrm_utils.py:198-207).
    Returns (celoss, dloss); dloss carries ``energy_weight``."""
    b, h, w = seg_label.shape
    pred = resize_bilinear(seg_logits, (h, w))
    pix = _per_pixel_nll(pred, seg_label)
    bg_mask = seg_label == 0
    fg_mask = (seg_label != 0) & (seg_label != 255)
    bg = torch.where(bg_mask, pix, 0.0).sum() / (bg_mask.sum() + 1e-6)
    fg = torch.where(fg_mask, pix, 0.0).sum() / (fg_mask.sum() + 1e-6)
    celoss = bg + fg

    # crop mask -> bounding box: the first and one past the last row and
    # column holding an in-crop pixel
    ys = (croppings > 0).any(dim=2).to(torch.int32)  # (B, H)
    xs = (croppings > 0).any(dim=1).to(torch.int32)  # (B, W)
    img_box = torch.stack([ys.argmax(dim=1), h - ys.flip(1).argmax(dim=1),
                           xs.argmax(dim=1), w - xs.flip(1).argmax(dim=1)], dim=1)
    dloss = get_energy_loss(images, pred, seg_label, img_box, weight=energy_weight,
                            sigma_rgb=sigma_rgb, sigma_xy=sigma_xy,
                            scale_factor=scale_factor, **energy_kwargs)
    return celoss, dloss


# ---------------------------------------------------------------------------
# Prototype-contrast regularizer (rrm_utils.py:245-340)
# ---------------------------------------------------------------------------

def compute_cos(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """``compute_cos`` (rrm_utils.py:245-251): pairwise cosine similarity of
    two row sets, with the reference's +1e-7 in the denominator."""
    n1 = torch.linalg.vector_norm(f1, dim=1, keepdim=True)
    n2 = torch.linalg.vector_norm(f2, dim=1, keepdim=True)
    return (f1 @ f2.T) / (n1 @ n2.T + 1e-7)


def _fg_fg_loss(fgc: torch.Tensor) -> torch.Tensor:
    """Mean (1 + cos) over the distinct pairs of foreground prototypes."""
    n = fgc.shape[0]
    if n < 2:
        return fgc.new_zeros(())
    fg_fg = 1.0 + compute_cos(fgc, fgc)
    return (fg_fg - torch.diag(torch.diag(fg_fg))).sum() / (n * (n - 1))


def compute_dis_no_batch(seg: torch.Tensor, seg_feature: torch.Tensor,
                         n_fg_classes: int = 20) -> torch.Tensor:
    """``compute_dis_no_batch`` (rrm_utils.py:254-340): the prototype-contrast
    regularizer over the seg argmax regions.

      * pixel_dis: the mean (1 - cos) distance of each region's pixels to
        its prototype, per-image background prototypes (an image with no
        background pixel adds the constant 2) and batch-wide per-class
        foreground ones, averaged over (B + the present classes);
      * dis_loss: prototype separation, the mean (1 + cos) over distinct
        fg/fg prototype pairs and over fg/bg pairs, blended 0.5/0.5; the
        reference's degenerate branches kept (no foreground pixel -> 0;
        foreground but no background -> the fg/fg term + 1).

    seg (B, H, W, 1 + n_fg) logits NHWC; seg_feature (B, H, W, C). It
    branches on values on the host. Returns shape (1,), as the reference."""
    b = seg.shape[0]
    c = seg_feature.shape[-1]
    labels = seg.argmax(dim=-1).reshape(b, -1)                     # (B, HW)
    feats = seg_feature.reshape(b, -1, c).to(torch.float32)        # (B, HW, C)

    bg_label = (labels == 0).to(torch.float32)
    bg_num_batch = bg_label.sum(dim=1) + 1e-7                      # (B,)
    bg_centers = (feats * bg_label[..., None]).sum(dim=1) / bg_num_batch[:, None]

    pixel_dis = feats.new_zeros((1,))
    for i in range(b):
        d = 1.0 - compute_cos(feats[i], bg_centers[i][None])[:, 0]
        if float(bg_num_batch[i]) >= 1:
            pixel_dis = pixel_dis + (d * bg_label[i]).sum() / bg_num_batch[i]
        else:
            pixel_dis = pixel_dis + 2.0

    flat_labels = labels.reshape(-1)
    flat_feats = feats.reshape(-1, c)
    fg_centers: List[torch.Tensor] = []
    batch_num = 0.0
    for class_i in range(1, n_fg_classes + 1):
        class_mask = (flat_labels == class_i).to(torch.float32)
        class_num = class_mask.sum() + 1e-7
        batch_num += float(class_num)
        if float(class_num) < 1:
            continue
        center = (flat_feats * class_mask[:, None]).sum(dim=0) / class_num
        d = 1.0 - compute_cos(flat_feats, center[None])[:, 0]
        pixel_dis = pixel_dis + (d * class_mask).sum() / class_num
        fg_centers.append(center)

    pixel_dis = pixel_dis / (len(fg_centers) + b)

    total_bg = float(bg_label.sum())
    if fg_centers and batch_num >= 1 and total_bg + 1e-7 >= 1:
        fgc = torch.stack(fg_centers)
        fg_bg = 1.0 + compute_cos(fgc, bg_centers)
        fg_bg_loss = fg_bg.sum() / (fg_bg.shape[0] * fg_bg.shape[1])
        dis_loss = 0.5 * _fg_fg_loss(fgc) + 0.5 * fg_bg_loss
    elif fg_centers and total_bg + 1e-7 < 1:
        dis_loss = 0.5 * _fg_fg_loss(torch.stack(fg_centers)) + 1.0
    else:
        dis_loss = feats.new_zeros(())
    return dis_loss + pixel_dis


# ---------------------------------------------------------------------------
# Data helpers (rrm_utils.py:130-242) and the helper.py PolyOptimizer
# ---------------------------------------------------------------------------

def read_file(path: str) -> List[str]:
    """rrm_utils.py:130-135 (strips exactly the trailing newline)."""
    with open(path) as f:
        return [line[:-1] if line.endswith("\n") else line for line in f]


def chunker(seq: Sequence, size: int) -> Iterator[Sequence]:
    """rrm_utils.py:138-139."""
    return (seq[pos:pos + size] for pos in range(0, len(seq), size))


def resize_label_batch(label: np.ndarray, size: int) -> np.ndarray:
    """rrm_utils.py:142-148: BILINEARLY resizes integer label maps
    (align_corners=True UpsamplingBilinear2d), then maps values > 21 to
    255; the interpolation on labels is the reference's.
    label (H, W, 1, B) -> (size, size, 1, B) float."""
    x = torch.from_numpy(np.ascontiguousarray(label.transpose(3, 0, 1, 2), np.float32))
    out = resize_bilinear_ac(x, (size, size)).numpy().copy()
    out[out > 21] = 255
    return out.transpose(1, 2, 3, 0)


def flip(img: np.ndarray, flip_p: float) -> np.ndarray:
    """rrm_utils.py:151-155."""
    return np.fliplr(img) if flip_p > 0.5 else img


def scale_im(img: np.ndarray, scale: float) -> np.ndarray:
    """rrm_utils.py:158-160 (cv2.resize default bilinear; PIL here)."""
    from PIL import Image

    h, w = int(img.shape[0] * scale), int(img.shape[1] * scale)
    return np.asarray(Image.fromarray(img.astype(np.uint8)).resize(
        (w, h), Image.BILINEAR)).astype(float)


def scale_gt(img: np.ndarray, scale: float) -> np.ndarray:
    """rrm_utils.py:163-165 (nearest)."""
    from PIL import Image

    h, w = int(img.shape[0] * scale), int(img.shape[1] * scale)
    return np.asarray(Image.fromarray(img.astype(np.uint8)).resize(
        (w, h), Image.NEAREST)).astype(float)


def random_crop_with_mask(
    imgarr: np.ndarray, cropsize: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """rrm_utils.py:174-207 ``RandomCrop``: crop-or-pad to cropsize² and
    return the boolean valid-pixel mask ("cropping") that
    compute_joint_loss gates the dense energy by. Unlike the live
    transforms.random_crop (which returns an img_box rectangle), the mask
    is materialized per pixel. Takes an explicit Generator like the rest of
    data/transforms.py."""
    h, w = imgarr.shape[:2]
    ch, cw = min(cropsize, h), min(cropsize, w)
    w_space, h_space = w - cropsize, h - cropsize

    cont_left, img_left = (0, int(rng.integers(w_space + 1))) if w_space > 0 \
        else (int(rng.integers(-w_space + 1)), 0)
    cont_top, img_top = (0, int(rng.integers(h_space + 1))) if h_space > 0 \
        else (int(rng.integers(-h_space + 1)), 0)

    container = np.zeros((cropsize, cropsize, imgarr.shape[-1]), np.float32)
    cropping = np.zeros((cropsize, cropsize), bool)
    container[cont_top:cont_top + ch, cont_left:cont_left + cw] = \
        imgarr[img_top:img_top + ch, img_left:img_left + cw]
    cropping[cont_top:cont_top + ch, cont_left:cont_left + cw] = True
    return container, cropping


def get_data_from_chunk_v2(
    chunk: Iterable[str],
    img_dir: str,
    crop_size: int,
    label_dict: Dict[str, np.ndarray],
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """rrm_utils.py:209-242: the RRM-era batcher — one shared U(0.7, 1.3)
    scale per chunk, per-image flip, torchvision-normalize, RandomCrop.
    Returns (images NHWC float32, ori_images NHWC uint8 de-normalized,
    labels (B, n_fg), croppings (B, H, W)). The reference's hard-coded
    voc12/cls_labels.npy load is the injected ``label_dict``."""
    import os

    from PIL import Image

    chunk = list(chunk)
    scale = float(rng.uniform(0.7, 1.3))
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    images = np.zeros((len(chunk), crop_size, crop_size, 3), np.float32)
    ori_images = np.zeros((len(chunk), crop_size, crop_size, 3), np.uint8)
    croppings = np.zeros((len(chunk), crop_size, crop_size), np.float32)
    labels = np.stack([label_dict[name] for name in chunk])

    for i, name in enumerate(chunk):
        img = np.asarray(Image.open(
            os.path.join(img_dir, name + ".jpg")).convert("RGB"))
        img = scale_im(img, scale)
        img = flip(img, float(rng.uniform(0, 1)))
        img = (img / 255.0 - mean) / std
        img, cropping = random_crop_with_mask(img, crop_size, rng)
        ori_images[i] = np.clip((img * std + mean) * 255.0, 0, 255).astype(np.uint8)
        croppings[i] = cropping.astype(np.float32)
        images[i] = img
    return images, ori_images, labels, croppings


def rrm_poly_sgd_schedule(base_lr: float, max_step: int,
                          momentum: float = 0.9) -> Callable[[int], float]:
    """helper.py:182-209 ``PolyOptimizer``'s lr(step), in f32: the first half
    decays base_lr by (1 - s/(max/2))^momentum (to 0 at the midpoint), the
    second restarts from the hard-coded 0.0007 and decays the same way; the
    ``momentum`` argument is the power. Past max_step the last value
    holds."""
    f = np.float32
    half = f(0.5 * max_step)

    def lr(step: int) -> float:
        s = f(min(step, max_step - 1))
        if s < half:
            return float(f(base_lr) * max(f(1.0) - s / half, f(0.0)) ** f(momentum))
        return float(f(0.0007) * (f(1.0) - (s - half) / (f(max_step) - half)) ** f(momentum))

    return lr


class RRMPolySGD(torch.optim.SGD):
    """helper.py's PolyOptimizer, bug included: its ``SGD(params, lr,
    weight_decay)`` call puts weight_decay in SGD's positional momentum
    slot, so momentum = weight_decay and no decay is applied. Each
    ``step()`` sets lr from :func:`rrm_poly_sgd_schedule` at the step count,
    then counts the step."""

    def __init__(self, params, base_lr: float, weight_decay: float, max_step: int,
                 momentum: float = 0.9):
        super().__init__(params, base_lr, weight_decay)  # the reference's positional call
        self.schedule = rrm_poly_sgd_schedule(base_lr, max_step, momentum)
        self.global_step = 0

    def step(self, closure=None):
        for g in self.param_groups:
            g["lr"] = self.schedule(self.global_step)
        loss = super().step(closure)
        self.global_step += 1
        return loss


def rrm_poly_sgd(params, base_lr: float, weight_decay: float, max_step: int,
                 momentum: float = 0.9) -> RRMPolySGD:
    """The torch twin of the JAX package's ``rrm_poly_sgd`` optax transform."""
    return RRMPolySGD(params, base_lr, weight_decay, max_step, momentum)
