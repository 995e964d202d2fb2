"""The pseudo mask (``kernels/cam2mask.py``, K8's wrapper) on the CPU.

A CPU tensor takes ``plain_cam2mask``, the chain as ``objectives/pseudo.py``
ran it (held against the JAX package by ``tests/test_torch_objectives.py``
and ``tests/test_torch_gmm_par.py``). What the kernel's design rests on is
held here in plain ops: the argmax over the background, the present classes
and the first absent class equals the argmax over every channel; the
wrapper's source taps are torch's; each label tile's low-res region holds
every tap of its pixels. The kernel itself is held against
``plain_cam2mask`` on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cosa_tpu_torch.kernels import cam2mask as K
from cosa_tpu_torch.objectives import pseudo
from cosa_tpu_torch.ops.resize import resize_bilinear
from cosa_tpu_torch.train import step


def _inputs(b=3, h=37, w=53, k=6, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    lab = (rng.random((b, k)) < 0.4).astype(np.float32)
    lab[0] = 0  # no class: every pixel background or ignored
    lab[-1] = 1  # every class
    cams = rng.random((b, h, w, k)).astype(np.float32) * lab[:, None, None, :]
    box = np.array([[0, h, 0, w], [2, -3, -40, -1], [-20, h, 5, w - 2]][:b], np.int32)
    return (torch.from_numpy(box), torch.from_numpy(cams).to(dtype), torch.from_numpy(lab))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tensor_thresholds", [False, True])
@pytest.mark.parametrize("refine", [False, True])
def test_wrapper_takes_the_plain_version_on_the_cpu(dtype, tensor_thresholds, refine):
    box, cams, lab = _inputs(dtype=dtype)
    hi, lo = (torch.tensor(0.7), torch.tensor(0.25)) if tensor_thresholds else (0.7, 0.25)
    kw = {}
    if refine:
        kw = dict(refine_fn=lambda imgs, p: p.flip(1) * imgs.mean(-1, keepdim=True),
                  images=torch.rand(3, 37, 53, 3))
    before = dict(K.LAUNCHES)
    got = K.cam2mask(box, cams, lab, hi, lo, 2, 255, **kw)
    want = K.plain_cam2mask(box, cams, lab, hi, lo, 2, 255, **kw)
    assert K.LAUNCHES == before  # the CPU takes the plain version
    assert got.dtype == torch.int32 and got.shape == (3, 37, 53)
    assert torch.equal(got, want)
    # the step and the pipelines call this wrapper by its old name
    assert pseudo.cam2mask is K.cam2mask and step.cam2mask is K.cam2mask


def _full_probs(cams, lab, thr, down):
    """The plain chain's full-crop probabilities of one threshold."""
    b, h, w, _ = cams.shape
    x = torch.cat([torch.full((b, h, w, 1), thr, dtype=cams.dtype), cams], -1)
    x = resize_bilinear(x, down)
    x = torch.where(K.with_bkg(lab)[:, None, None, :] == 0, torch.full_like(x, K.NEG_INF), x)
    return resize_bilinear(torch.softmax(x.to(torch.float32), -1), (h, w))


@pytest.mark.parametrize("thr", [0.7, 0.25, 1.5])
def test_the_argmax_over_the_listed_channels_is_the_full_argmax(thr):
    """Every absent class has one logit, so one probability: the first
    absent class stands for all of them. (With logits near -1e5 that
    probability is not 0 and can win; the CPU's softmax and resize round
    some channels apart from others there, the card's do not, so
    tests/test_torch_cuda.py holds that case.)"""
    box, cams, lab = _inputs(b=3, k=9, seed=1)
    probs = _full_probs(cams, lab, thr, (18, 26))
    full = probs.argmax(-1)
    listed = []
    for n in range(lab.shape[0]):
        absent = [c + 1 for c in range(lab.shape[1]) if lab[n, c] == 0]
        chans = sorted({0, *(c + 1 for c in range(lab.shape[1]) if lab[n, c] != 0),
                        *absent[:1]})
        idx = torch.tensor(chans)
        listed.append(idx[probs[n][..., idx].argmax(-1)])
    assert torch.equal(full, torch.stack(listed))
    assert (full > 0).any() == (thr < 1)


@pytest.mark.parametrize("n_in,n_out", [(448, 224), (224, 448), (500, 250), (250, 500),
                                        (353, 176), (176, 353), (7, 3), (3, 7), (5, 5)])
def test_source_taps_are_torch_bilinear(n_in, n_out):
    """Each output index's nonzero weights of torch's own bilinear resize
    (a resize of the identity) sit at the taps the wrapper computes."""
    eye = torch.eye(n_in, dtype=torch.float64)[:, None, None, :]
    wts = F.interpolate(eye, size=(1, n_out), mode="bilinear", align_corners=False)[:, 0, 0, :]
    i0, i1 = K.source_taps(n_in, n_out)
    for j in range(n_out):
        nz = set(torch.nonzero(wts[:, j]).flatten().tolist())
        assert nz <= {int(i0[j]), int(i1[j])} and int(i0[j]) in nz | {int(i1[j])}, j


@pytest.mark.parametrize("h,w,downscale,c,tile", [
    (448, 448, 2, 21, (32, 32)), (448, 448, 2, 81, (32, 32)), (500, 500, 2, 21, (32, 32)),
    (353, 500, 2, 21, None), (448, 448, 1, 81, None), (37, 53, 3, 6, None),
    (448, 448, 2, 256, None)])
def test_each_label_tile_region_holds_its_taps(h, w, downscale, c, tile):
    dh, dw = h // downscale, w // downscale
    ty, tx, ry, rx = K.plan(h, w, dh, dw, c)
    assert tile is None or (ty, tx) == tile
    assert K.smem_bytes(ry, rx, c) <= 227 * 1024 and ty * tx <= 4 * 256
    for n_out, n_in, t, r in ((h, dh, ty, ry), (w, dw, tx, rx)):
        if (dh, dw) == (h, w):
            assert r >= t
            continue
        i0, i1 = K.source_taps(n_in, n_out)
        for a in range(0, n_out, t):
            lo, hi = i0[a:a + t], i1[a:a + t]
            assert hi.max() - lo.min() + 1 <= r and 0 <= lo.min() and hi.max() < n_in


def test_a_threshold_is_passed_as_the_kernel_reads_it():
    assert K._threshold(0.65, torch.device("cpu")) == (None, 0.65)
    t, v = K._threshold(torch.tensor(0.3, dtype=torch.float64), torch.device("cpu"))
    assert t is None and v == 0.3  # a CPU scalar, by value
    with pytest.raises(ValueError, match="0-d"):
        K._threshold(torch.tensor([0.3]), torch.device("cpu"))
