"""The teacher TTA's multi-scale x flip fuse: kernel K5 and its plain version.

Every scale's forward gives the CAM and the seg logits of the images and of
their flips at the scale's patch grid. The fuse resizes each to the crop
(bilinear, torch's ``align_corners=False``), flips the second half back,
takes the flip-wise max of the CAMs and their scale-wise ReLU sum, sums the
seg logits, takes the last scale's aux CAM, and min-max normalizes both
CAMs per (image, channel). The plain version is ``multi_scale_camseg``'s
arithmetic as it stood, one library op per step. The kernel
(``csrc/tta_fuse.cu``) replaces no Pallas kernel: in the JAX package XLA
fused this chain into its resize products. It reads the small per-scale
maps and writes each full-crop output once, rounding where the plain
version rounds and contracting the interpolation's products into FMAs as
torch's build of its bilinear kernels does, so the two agree on the card
bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from cosa_tpu_torch.kernels import counter
from cosa_tpu_torch.ops.resize import resize_bilinear

LAUNCHES = counter("tta_fuse")

MAX_SCALES = 8  # the kernel's per-scale arguments are fixed arrays of this size
CAM_DTYPES = (torch.bfloat16, torch.float32)

_VP = ctypes.c_void_p
_TYPED = []


def _lib():
    from cosa_tpu_torch.kernels.build import load

    lib = load("tta_fuse")
    if lib not in _TYPED:
        lib.cosa_tta_fuse.argtypes = [
            ctypes.POINTER(_VP), ctypes.POINTER(_VP), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _VP, _VP,
            _VP, _VP]
        lib.cosa_tta_fuse.restype = ctypes.c_int
        _TYPED.append(lib)
    return lib


def minmax_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(sample, channel) spatial min-max normalization."""
    mn = x.amin(dim=(1, 2), keepdim=True)
    mx = (x - mn).amax(dim=(1, 2), keepdim=True)
    return (x - mn) / (mx + eps)


def _check_scales(cams: Sequence[torch.Tensor], segs: Sequence[torch.Tensor]) -> None:
    if not 1 <= len(cams) <= MAX_SCALES or len(segs) != len(cams):
        raise ValueError(f"tta_fuse: 1 to {MAX_SCALES} scales, one CAM and one seg map "
                         f"each; got {len(cams)} CAMs and {len(segs)} seg maps")


def plain_tta_fuse(cams: Sequence[torch.Tensor], segs: Sequence[torch.Tensor],
                   cam_aux_last: torch.Tensor, size: Tuple[int, int], cam_dtype=torch.float32):
    """(cam, cam_aux, seg_sum) from each scale's (2B, h', w', C) CAM and seg
    logits and the last scale's aux CAM: library ops, the CAM arithmetic in
    ``cam_dtype``, the seg logits in f32."""
    _check_scales(cams, segs)
    b = cams[0].shape[0] // 2
    cam_sum = 0.0
    seg_sum = 0.0
    for cam_raw, seg_raw in zip(cams, segs):
        cam_raw = cam_raw.to(cam_dtype)
        cam = torch.maximum(
            resize_bilinear(cam_raw[:b], size),
            resize_bilinear(cam_raw[b:], size, flip_w=True),
        )
        seg_raw = seg_raw.to(torch.float32)
        seg = resize_bilinear(seg_raw[:b], size) + resize_bilinear(
            seg_raw[b:], size, flip_w=True
        )
        cam_sum = cam_sum + F.relu(cam)
        seg_sum = seg_sum + seg
    aux_raw = cam_aux_last.to(cam_dtype)
    cam_aux_last = F.relu(torch.maximum(
        resize_bilinear(aux_raw[:b], size),
        resize_bilinear(aux_raw[b:], size, flip_w=True),
    ))
    cam = minmax_norm(cam_sum).to(torch.float32)
    cam_aux = minmax_norm(cam_aux_last).to(torch.float32)
    return cam, cam_aux, seg_sum


def tta_fuse(cams: Sequence[torch.Tensor], segs: Sequence[torch.Tensor],
             cam_aux_last: torch.Tensor, size: Tuple[int, int], cam_dtype=torch.float32):
    """K5. ``cams``/``segs``: one (2B, h', w', C) / (2B, h', w', C + 1) f32
    map a scale (images, then their flips; at most 8 scales), ``cam_aux_last``
    the last scale's aux CAM on its own grid (the last scale's with a ViT,
    twice as fine with Swin), ``size`` the crop (H, W) -> the normalized CAM
    and aux CAM (B, H, W, C) f32 and the seg sum (B, H, W, C + 1) f32. A CPU
    tensor takes the plain version."""
    _check_scales(cams, segs)
    if cams[0].device.type == "cpu":
        return plain_tta_fuse(cams, segs, cam_aux_last, size, cam_dtype)
    if cam_dtype not in CAM_DTYPES:
        raise ValueError(f"tta_fuse: cam_dtype must be one of {CAM_DTYPES}, got {cam_dtype}")
    dev = cams[0].device
    cams = [x.contiguous() for x in cams]
    segs = [x.contiguous() for x in segs]
    aux = cam_aux_last.contiguous()
    b2, c_cam, c_seg = cams[0].shape[0], cams[0].shape[-1], segs[0].shape[-1]
    maps = [("cam", x, c_cam) for x in cams] + [("seg", x, c_seg) for x in segs]
    for name, x, c in maps + [("cam_aux", aux, c_cam)]:
        if x.device != dev or x.dtype != torch.float32 or x.dim() != 4 \
                or x.shape[0] != b2 or b2 % 2 or x.shape[-1] != c:
            raise ValueError(
                f"tta_fuse: every {name} map must be an f32 (2B, h', w', C) tensor on {dev} "
                f"with 2B = {b2} and C = {c}; got {x.dtype} {tuple(x.shape)} on {x.device}")
    for cam, seg in zip(cams, segs):
        if cam.shape[1:3] != seg.shape[1:3]:
            raise ValueError(f"tta_fuse: a scale's CAM and seg grids differ: "
                             f"{tuple(cam.shape)}, {tuple(seg.shape)}")
    b = b2 // 2
    h, w = (int(v) for v in size)
    if b * h * w * max(c_cam, c_seg) >= 2 ** 31:
        raise ValueError(f"tta_fuse: a {b}x{h}x{w} output of {max(c_cam, c_seg)} channels "
                         f"exceeds 2^31 values")
    n = len(cams)
    f32 = cam_dtype == torch.float32
    cam_tmp = torch.empty((b, h, w, c_cam), dtype=cam_dtype, device=dev)
    aux_tmp = torch.empty_like(cam_tmp)
    # an f32 sum is normalized in place; a bf16 sum into a new f32 map
    cam_out = cam_tmp if f32 else torch.empty((b, h, w, c_cam), dtype=torch.float32, device=dev)
    aux_out = aux_tmp if f32 else torch.empty_like(cam_out)
    seg_out = torch.empty((b, h, w, c_seg), dtype=torch.float32, device=dev)
    stats = torch.empty((4, b, c_cam), dtype=torch.int32, device=dev)
    cam_ptrs = (_VP * n)(*(x.data_ptr() for x in cams))
    seg_ptrs = (_VP * n)(*(x.data_ptr() for x in segs))
    grids = (ctypes.c_int * (2 * n))(*(v for x in cams for v in x.shape[1:3]))
    with torch.cuda.device(dev):
        err = _lib().cosa_tta_fuse(
            cam_ptrs, seg_ptrs, grids, n, aux.data_ptr(), aux.shape[1], aux.shape[2], b, h, w,
            c_cam, c_seg, int(f32), cam_tmp.data_ptr(), aux_tmp.data_ptr(), seg_out.data_ptr(),
            cam_out.data_ptr(), aux_out.data_ptr(), stats.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"cosa_tta_fuse failed: cudaError_t {err}")
    LAUNCHES["tta_fuse"] += 1
    return cam_out, aux_out, seg_out
