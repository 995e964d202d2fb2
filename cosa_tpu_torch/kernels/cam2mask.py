"""CAM -> hard pseudo mask: kernel K8 and its plain version.

The plain version is the chain ``objectives/pseudo.py::cam2mask`` ran as
library ops (reference seg_helper.py:721-797, batched): for the high and
the low background threshold in turn, the background channel before the
CAMs, a bilinear resize to the downscaled grid, absent classes set to
-1e5, an f32 softmax, the optional refine step (PAR), a bilinear resize
back to the crop and the argmax; then the merge and the crop box. Each
threshold pass writes and reads maps of every channel in f32 at the full
crop.

The kernel (``csrc/cam2mask.cu``) replaces no Pallas kernel: in the JAX
package XLA fused this chain. It shares the CAM reads and the resize taps
between the two thresholds, reads only the present classes' CAMs, keeps
the low-res probabilities in shared memory and writes only the int32
labels: one launch a call, two with a refine step (the low-res
probabilities out to the refine step, then the labels). It rounds where
the plain chain rounds and sums its softmax as torch's does, so the labels
agree on the card. A wrapper launches it for a CUDA tensor, or raises; it
takes the plain version only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cosa_tpu_torch.kernels import counter
from cosa_tpu_torch.ops.resize import resize_bilinear

NEG_INF = -1e5  # reference uses -1e5 for invalid-class logits (seg_helper.py:565)
CAM_DTYPES = (torch.bfloat16, torch.float32)
MAX_CHANNELS = 256  # classes + background: the kernel's softmax holds 8 a lane
CHUNK = 16  # listed channels in shared memory at a time (csrc/cam2mask.cu's CHUNK)
# a block's output tiles (rows, columns), widest first; the widest whose
# region's low-res probabilities (a chunk of each threshold) fit SMEM_TARGET
# bytes of shared memory is taken
TILES = ((32, 32), (16, 32), (16, 16), (8, 16), (8, 8), (4, 8), (4, 4))
SMEM_TARGET = 48 * 1024  # no opt-in; four blocks an SM

# launches on the card: the label pass (fused, or after a refine step) and
# the probabilities' pass before a refine step; plain integers
LAUNCHES = counter("cam2mask", "cam2mask_probs")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_TYPED = []  # libraries whose C signatures are set


def _lib():
    from cosa_tpu_torch.kernels.build import load

    lib = load("cam2mask")
    if lib not in _TYPED:
        lib.cosa_cam2mask.argtypes = [_VP, _I, _VP, _VP, _I, _VP, _VP, _F, _F] + [_I] * 11 + [
            _VP, _VP]
        lib.cosa_cam2mask.restype = _I
        lib.cosa_cam2mask_probs.argtypes = [_VP, _I, _VP, _VP, _VP, _F, _F] + [_I] * 6 + [
            _VP] * 3
        lib.cosa_cam2mask_probs.restype = _I
        lib.cosa_cam2mask_from_probs.argtypes = [_VP, _VP, _I, _VP, _I] + [_I] * 11 + [_VP, _VP]
        lib.cosa_cam2mask_from_probs.restype = _I
        _TYPED.append(lib)
    return lib


def box_mask(img_box: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B,4) [h0,h1,w0,w1] -> (B,h,w) bool inside-box mask (slice semantics)."""
    box = img_box.to(torch.int64)
    h0, h1, w0, w1 = box[:, 0], box[:, 1], box[:, 2], box[:, 3]
    h0 = torch.where(h0 < 0, h0 + h, h0)[:, None, None]
    h1 = torch.where(h1 < 0, h1 + h, h1)[:, None, None]
    w0 = torch.where(w0 < 0, w0 + w, w0)[:, None, None]
    w1 = torch.where(w1 < 0, w1 + w, w1)[:, None, None]
    iy = torch.arange(h, device=box.device)[None, :, None]
    ix = torch.arange(w, device=box.device)[None, None, :]
    return (iy >= h0) & (iy < h1) & (ix >= w0) & (ix < w1)


def with_bkg(cls_label: torch.Tensor) -> torch.Tensor:
    """(B, C-1) class labels -> (B, C), the background's 1 first."""
    ones = torch.ones((cls_label.shape[0], 1), dtype=cls_label.dtype,
                      device=cls_label.device)
    return torch.cat([ones, cls_label], dim=1)


def _threshold_argmax(cams_with_bkg, lab_bk, down, orig, refine_fn=None,
                      images_down=None) -> torch.Tensor:
    """softmax over present channels at low res -> (refine) -> upsample -> argmax."""
    x = resize_bilinear(cams_with_bkg, down) if down != orig else cams_with_bkg
    x = torch.where(lab_bk[:, None, None, :] == 0,
                    torch.full_like(x, NEG_INF), x)
    probs = torch.softmax(x.to(torch.float32), dim=-1)
    if refine_fn is not None:
        probs = refine_fn(images_down, probs)
    probs = resize_bilinear(probs, orig)
    return torch.argmax(probs, dim=-1).to(torch.int32)


def plain_cam2mask(
    img_box: torch.Tensor,
    cams: torch.Tensor,
    cls_labels: torch.Tensor,
    threshold_high,
    threshold_low,
    downscale: int = 2,
    ignore_index: int = 255,
    refine_fn: Optional[Callable] = None,
    images: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`cam2mask` as library ops."""
    b, h, w, _ = cams.shape
    ones = torch.ones((b, h, w, 1), dtype=cams.dtype, device=cams.device)
    lab_bk = with_bkg(cls_labels)
    down = (h // downscale, w // downscale) if downscale else (h, w)
    images_down = None
    if refine_fn is not None:
        if images is None:
            raise ValueError("cam2mask with refine_fn needs images")
        images_down = resize_bilinear(images, down) if down != (h, w) else images
    hi = _threshold_argmax(torch.cat([ones * threshold_high, cams], dim=-1), lab_bk,
                           down, (h, w), refine_fn, images_down)
    lo = _threshold_argmax(torch.cat([ones * threshold_low, cams], dim=-1), lab_bk,
                           down, (h, w), refine_fn, images_down)
    ign = torch.full_like(hi, ignore_index)
    label = torch.where(hi == 0, ign, hi)
    label = torch.where((hi + lo) == 0, torch.zeros_like(hi), label)
    inside = box_mask(img_box, h, w)
    return torch.where(inside, label, ign)


def source_taps(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The near and far source index of each output index of torch's
    bilinear resize (``align_corners=False``) from ``n_in`` to ``n_out``, in
    the card's f32 arithmetic: the source position scale * (dst + 0.5) - 0.5
    rounds once (one FMA), the scale being f32(n_in) / f32(n_out). The f64
    product of the f32 scale and dst + 0.5 is exact, so its one rounding to
    f32 is the FMA's."""
    scale = np.float64(np.float32(n_in) / np.float32(n_out))
    src = (scale * (np.arange(n_out, dtype=np.float64) + 0.5) - 0.5).astype(np.float32)
    i0 = np.maximum(src, 0).astype(np.int64)
    return i0, np.minimum(i0 + 1, n_in - 1)


def _span(n_out: int, n_in: int, t: int) -> int:
    """The most low-res indices under a tile of ``t`` output indices."""
    i0, i1 = source_taps(n_in, n_out)
    starts = np.arange(0, n_out, t)
    ends = np.minimum(starts + t, n_out) - 1
    return int((i1[ends] - i0[starts]).max()) + 1


def smem_bytes(ry: int, rx: int, c: int) -> int:
    """The label pass's shared memory for a region of ry x rx low-res
    pixels: a chunk of both thresholds' probabilities, at an odd stride."""
    return 2 * ry * rx * (min(c, CHUNK) | 1) * 4


@functools.lru_cache(maxsize=256)
def plan(h: int, w: int, dh: int, dw: int, c: int) -> Tuple[int, int, int, int]:
    """(tile rows, tile columns, region rows, region columns) of the label
    pass from the crop (h, w) through the grid (dh, dw), ``c`` channels:
    the widest tile of :data:`TILES` whose region (every low-res tap of
    its pixels) holds a chunk of both thresholds' probabilities in
    SMEM_TARGET bytes, else the narrowest."""
    resize = (dh, dw) != (h, w)
    for ty, tx in TILES:
        ry = _span(h, dh, ty) if resize else ty
        rx = _span(w, dw, tx) if resize else tx
        if smem_bytes(ry, rx, c) <= SMEM_TARGET or (ty, tx) == TILES[-1]:
            return ty, tx, ry, rx
    raise AssertionError("unreachable")


def _threshold(t, dev: torch.device):
    """(device tensor or None, float) of a threshold: a 0-d tensor on the
    card is read there by the kernel (no host sync); a number or a CPU
    scalar is passed by value, as torch passes a scalar operand."""
    if isinstance(t, torch.Tensor):
        if t.dim() != 0:
            raise ValueError(f"cam2mask: a threshold tensor must be 0-d, got {tuple(t.shape)}")
        if t.device.type == "cpu":
            return None, float(t)
        if t.device != dev:
            raise ValueError(f"cam2mask: a threshold on {t.device}, the CAMs on {dev}")
        return t.detach().to(torch.float32), 0.0
    return None, float(t)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def cam2mask(
    img_box: torch.Tensor,
    cams: torch.Tensor,
    cls_labels: torch.Tensor,
    threshold_high,
    threshold_low,
    downscale: int = 2,
    ignore_index: int = 255,
    refine_fn: Optional[Callable] = None,
    images: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CAM -> hard pseudo mask (reference seg_helper.py:721-797), batched.

    cams: (B,H,W,C-1) validated CAMs; the thresholds are floats or 0-d
    tensors (the GMM's EMAs). ``refine_fn(images_down, probs)`` is the
    optional PAR pass on the (B,h,w,C) probabilities at the downscaled
    resolution; it needs ``images`` (B,H,W,3, denormalized to 0-1). Merge
    rule: start from the high-threshold label; where high says bkg ->
    ignore; where both say bkg -> bkg; outside the img_box -> ignore.
    Returns (B,H,W) int32. K8 on the card; a CPU tensor takes
    :func:`plain_cam2mask`."""
    if cams.device.type == "cpu":
        return plain_cam2mask(img_box, cams, cls_labels, threshold_high, threshold_low,
                              downscale, ignore_index, refine_fn, images)
    dev = cams.device
    if cams.dtype not in CAM_DTYPES or cams.dim() != 4:
        raise ValueError(f"cam2mask: cams must be a (B, H, W, C-1) tensor of {CAM_DTYPES}, "
                         f"got {cams.dtype} {tuple(cams.shape)}")
    b, h, w, k = cams.shape
    c = k + 1
    if not 2 <= c <= MAX_CHANNELS:
        raise ValueError(f"cam2mask: 1 to {MAX_CHANNELS - 1} classes, got {k}")
    if tuple(cls_labels.shape) != (b, k) or tuple(img_box.shape) != (b, 4):
        raise ValueError(f"cam2mask: cls_labels must be ({b}, {k}) and img_box ({b}, 4), "
                         f"got {tuple(cls_labels.shape)} and {tuple(img_box.shape)}")
    if cls_labels.device != dev or img_box.device != dev:
        raise ValueError(f"cam2mask: cls_labels on {cls_labels.device} and img_box on "
                         f"{img_box.device}, the CAMs on {dev}")
    down = (h // downscale, w // downscale) if downscale else (h, w)
    if min(down) < 1 or b > 65535:
        raise ValueError(f"cam2mask: a {b} x {h} x {w} batch at downscale {downscale}")
    cams = cams.contiguous()
    labels = cls_labels.to(torch.float32).contiguous()
    box = img_box if img_box.dtype in (torch.int32, torch.int64) else img_box.to(torch.int64)
    box = box.contiguous()
    box64 = int(box.dtype == torch.int64)
    (thi, vhi), (tlo, vlo) = _threshold(threshold_high, dev), _threshold(threshold_low, dev)
    f32 = int(cams.dtype == torch.float32)
    ty, tx, ry, rx = plan(h, w, down[0], down[1], c)
    out = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if refine_fn is None:
        with torch.cuda.device(dev):
            err = _lib().cosa_cam2mask(
                cams.data_ptr(), f32, labels.data_ptr(), box.data_ptr(), box64, _ptr(thi),
                _ptr(tlo), vhi, vlo, b, h, w, c, down[0], down[1], ignore_index, ty, tx, ry, rx,
                out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"cosa_cam2mask failed: cudaError_t {err}")
        LAUNCHES["cam2mask"] += 1
        return out
    if images is None:
        raise ValueError("cam2mask with refine_fn needs images")
    images_down = resize_bilinear(images, down) if down != (h, w) else images
    probs = [torch.empty((b, down[0], down[1], c), dtype=torch.float32, device=dev)
             for _ in range(2)]
    with torch.cuda.device(dev):
        err = _lib().cosa_cam2mask_probs(
            cams.data_ptr(), f32, labels.data_ptr(), _ptr(thi), _ptr(tlo), vhi, vlo, b, h, w, c,
            down[0], down[1], probs[0].data_ptr(), probs[1].data_ptr(), stream)
    if err:
        raise RuntimeError(f"cosa_cam2mask_probs failed: cudaError_t {err}")
    LAUNCHES["cam2mask_probs"] += 1
    refined = [refine_fn(images_down, p) for p in probs]
    for r in refined:
        if r.dtype != torch.float32 or tuple(r.shape) != tuple(probs[0].shape) \
                or r.device != dev:
            raise ValueError(f"cam2mask: refine_fn must return f32 {tuple(probs[0].shape)} "
                             f"maps on {dev}, got {r.dtype} {tuple(r.shape)} on {r.device}")
    # the plain chain's resize takes torch's channels-last kernel only for
    # channels-last maps of 16 channels or more
    nhwc = int(c >= 16 and all(r.is_contiguous() for r in refined))
    refined = [r.contiguous() for r in refined]
    with torch.cuda.device(dev):
        err = _lib().cosa_cam2mask_from_probs(
            refined[0].data_ptr(), refined[1].data_ptr(), nhwc, box.data_ptr(), box64, b, h, w,
            c, down[0], down[1], ignore_index, ty, tx, ry, rx, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"cosa_cam2mask_from_probs failed: cudaError_t {err}")
    LAUNCHES["cam2mask"] += 1
    return out
