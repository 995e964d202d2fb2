"""The TTA fuse (``kernels/tta_fuse.py``) on the CPU.

``multi_scale_camseg`` now keeps each scale's raw maps and fuses them in one
``tta_fuse`` call; on the CPU that call runs ``plain_tta_fuse``. Its outputs
must equal, bitwise, those of the fuse as it was written inside the scale
loop (``_old_multi_scale_camseg`` below, kept verbatim as the oracle), at the
channel counts, CAM types and scale sets the paths use, on odd, non-square
crops. The kernel itself is held against ``plain_tta_fuse`` on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cosa_tpu_torch.kernels import tta_fuse as K
from cosa_tpu_torch.objectives import pseudo
from cosa_tpu_torch.kernels.tta_fuse import minmax_norm
from cosa_tpu_torch.objectives.pseudo import multi_scale_camseg, scale_size
from cosa_tpu_torch.ops.image import hflip
from cosa_tpu_torch.ops.resize import resize_bilinear

TRAIN_SCALES = (1.0, 0.5, 1.5)
EVAL_SCALES = (1.0, 0.5, 1.5, 0.75, 1.25)


def _old_multi_scale_camseg(forward, imgs, scales, getcls=False, cam_dtype=torch.float32):
    """``multi_scale_camseg`` before the fuse left the loop."""
    b, h, w, _ = imgs.shape
    cam_sum = 0.0
    cam_aux_last = None
    seg_sum = 0.0
    cls_sum = 0.0
    cls_aux_sum = 0.0
    for i, s in enumerate(scales):
        if s == 1.0:
            xcat = torch.cat([imgs, hflip(imgs)], dim=0)
        else:
            sz = scale_size(h, w, s)
            xcat = torch.cat(
                [resize_bilinear(imgs, sz), resize_bilinear(imgs, sz, flip_w=True)],
                dim=0,
            )
        out = forward(xcat)
        cam_raw = out["cam"].to(cam_dtype)
        cam = torch.maximum(
            resize_bilinear(cam_raw[:b], (h, w)),
            resize_bilinear(cam_raw[b:], (h, w), flip_w=True),
        )
        seg_raw = out["seg"].to(torch.float32)
        seg = resize_bilinear(seg_raw[:b], (h, w)) + resize_bilinear(
            seg_raw[b:], (h, w), flip_w=True
        )
        cam_sum = cam_sum + F.relu(cam)
        seg_sum = seg_sum + seg
        if i == len(scales) - 1:
            aux_raw = out["cam_aux"].to(cam_dtype)
            cam_aux_last = F.relu(torch.maximum(
                resize_bilinear(aux_raw[:b], (h, w)),
                resize_bilinear(aux_raw[b:], (h, w), flip_w=True),
            ))
        if getcls:
            c = out["cls"].to(torch.float32)
            ca = out["cls_aux"].to(torch.float32)
            cls_sum = cls_sum + c[:b] + c[b:]
            cls_aux_sum = cls_aux_sum + ca[:b] + ca[b:]
    cam = minmax_norm(cam_sum).to(torch.float32)
    cam_aux = minmax_norm(cam_aux_last).to(torch.float32)
    if getcls:
        return cam, cam_aux, seg_sum, cls_sum, cls_aux_sum
    return cam, cam_aux, seg_sum


def _forward(n_cls: int, seed: int = 0, aux_fine: int = 1):
    """A model stand-in: each map a fixed linear function of the input
    resized to an odd, non-square patch grid (h'/5 x w'/3), so that the
    flipped half differs from the first and every scale has its own grid;
    the aux CAM on a grid ``aux_fine`` times as fine (2: as Swin gives it)."""
    g = np.random.default_rng(seed)
    wc, wa, ws = (torch.from_numpy(g.standard_normal((3, k)).astype(np.float32))
                  for k in (n_cls, n_cls, n_cls + 1))

    def fwd(x):
        grid = (max(1, x.shape[1] // 5), max(1, x.shape[2] // 3))
        y = resize_bilinear(x, grid)
        ya = resize_bilinear(x, tuple(aux_fine * k for k in grid))
        cam = y @ wc
        return dict(cam=cam, cam_aux=ya @ wa - 0.5, seg=y @ ws,
                    cls=cam.mean(dim=(1, 2)), cls_aux=cam.amax(dim=(1, 2)))
    return fwd


def _imgs(b=2, h=37, w=53, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, h, w, 3)).astype(np.float32))


@pytest.mark.parametrize("scales", [TRAIN_SCALES, EVAL_SCALES])
@pytest.mark.parametrize("cam_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_cls", [20, 21, 80, 81])
def test_fuse_equals_the_in_loop_arithmetic(n_cls, cam_dtype, scales):
    fwd, imgs = _forward(n_cls), _imgs()
    before = K.LAUNCHES["tta_fuse"]
    ours = multi_scale_camseg(fwd, imgs, scales, getcls=True, cam_dtype=cam_dtype)
    ref = _old_multi_scale_camseg(fwd, imgs, scales, getcls=True, cam_dtype=cam_dtype)
    assert K.LAUNCHES["tta_fuse"] == before  # the CPU takes the plain version
    for a, r in zip(ours, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        assert torch.equal(a, r)
    b, h, w, _ = imgs.shape
    assert ours[0].shape == (b, h, w, n_cls) and ours[2].shape == (b, h, w, n_cls + 1)
    assert ours[0].dtype == ours[1].dtype == ours[2].dtype == torch.float32


@pytest.mark.parametrize("scales", [TRAIN_SCALES, EVAL_SCALES])
@pytest.mark.parametrize("cam_dtype", [torch.bfloat16, torch.float32])
def test_fuse_takes_the_aux_cam_on_its_own_grid(cam_dtype, scales):
    fwd, imgs = _forward(20, aux_fine=2), _imgs()
    ours = multi_scale_camseg(fwd, imgs, scales, cam_dtype=cam_dtype)
    ref = _old_multi_scale_camseg(fwd, imgs, scales, cam_dtype=cam_dtype)
    assert all(torch.equal(a, r) for a, r in zip(ours, ref))
    assert ours[1].shape == (2, 37, 53, 20)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    fwd, imgs = _forward(21), _imgs()
    outs = [fwd(torch.cat([imgs, hflip(imgs)], 0))]
    cams, segs = [o["cam"] for o in outs], [o["seg"] for o in outs]
    before = K.LAUNCHES["tta_fuse"]
    got = K.tta_fuse(cams, segs, outs[-1]["cam_aux"], (37, 53), torch.bfloat16)
    want = K.plain_tta_fuse(cams, segs, outs[-1]["cam_aux"], (37, 53), torch.bfloat16)
    assert K.LAUNCHES["tta_fuse"] == before
    assert all(torch.equal(a, r) for a, r in zip(got, want))
    assert pseudo.tta_fuse is K.tta_fuse  # the fuse multi_scale_camseg calls


def test_more_than_eight_scales_raise():
    fwd, imgs = _forward(20), _imgs()
    out = fwd(torch.cat([imgs, hflip(imgs)], 0))
    for fn in (K.tta_fuse, K.plain_tta_fuse):
        with pytest.raises(ValueError, match="1 to 8 scales"):
            fn([out["cam"]] * 9, [out["seg"]] * 9, out["cam_aux"], (37, 53))
        with pytest.raises(ValueError, match="1 to 8 scales"):
            fn([out["cam"]] * 2, [out["seg"]], out["cam_aux"], (37, 53))
    with pytest.raises(ValueError, match="1 to 8 scales"):
        multi_scale_camseg(fwd, imgs, (1.0,) + (0.5,) * 8)
