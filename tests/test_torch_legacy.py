"""PyTorch port vs the JAX package: the legacy surface that no live path
uses (objectives/variants.py, utils/rrm.py, data/imutils.py, Evaluator,
cross_entropy_ignore, the resize dispatcher, the batched native lattice).

The cases of tests/test_variants.py, tests/test_rrm.py and
tests/test_dead_components.py:50-160, 303-375 go through both packages on
the same numpy inputs (the seeded transforms with one numpy Generator
seed each). Tolerances, each stated at its check: f32 losses and maps
within 1e-5 relative (the resizes interpolate in f32 in the port, by
HIGH-precision matmuls in JAX: ~3e-6 of the range, ROADMAP Queue 3);
integer outputs, masks, labels and the numpy transforms equal; the CRF
wrappers run the same native C++ lattice and numpy on both sides: within
1e-6."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax

from cosa_tpu.data import imutils as jim
from cosa_tpu.eval.metrics import Evaluator as JEvaluator
from cosa_tpu.native.build import lattice_gaussian_batch_cpu as j_lattice_batch
from cosa_tpu.objectives import losses as jlosses
from cosa_tpu.objectives import variants as jv
from cosa_tpu.ops.resize import resize as jresize
from cosa_tpu.utils import rrm as jrrm
from cosa_tpu_torch.data import imutils as tim
from cosa_tpu_torch.eval.metrics import Evaluator
from cosa_tpu_torch.native.build import lattice_gaussian_batch_cpu, lattice_gaussian_cpu
from cosa_tpu_torch.objectives import losses as tlosses
from cosa_tpu_torch.objectives import pseudo as tpseudo
from cosa_tpu_torch.objectives import variants as tv
from cosa_tpu_torch.ops.resize import resize
from cosa_tpu_torch.utils import rrm

B, H, W, C = 2, 12, 12, 5
T = torch.from_numpy


def _close(ours, ref, rtol=1e-5, atol=1e-6, msg=""):
    ours = ours.detach().float().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref, np.float32), rtol=rtol, atol=atol,
                               err_msg=msg)


def _logits(seed):
    return np.random.default_rng(seed).normal(size=(B, H, W, C)).astype(np.float32)


def _labels(seed, ignore_frac=0.2):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, C, (B, H, W)).astype(np.int32)
    lab[rng.random((B, H, W)) < ignore_frac] = 255
    return lab


# ---------------------------------------------------------------------------
# objectives: losses, variants
# ---------------------------------------------------------------------------

def test_cross_entropy_ignore_matches_jax():
    logits, lab = _logits(0), _labels(1)
    s_t, n_t = tlosses.cross_entropy_ignore(T(logits), T(lab))
    s_j, n_j = jlosses.cross_entropy_ignore(jnp.asarray(logits), jnp.asarray(lab))
    _close(s_t, s_j)
    assert int(n_t) == int(n_j)


def test_seg_losses_match_jax():
    logits, lab = _logits(2), _labels(3)
    wts = np.random.default_rng(4).random((B, H, W)).astype(np.float32)
    probs = np.array(jax.nn.softmax(jnp.asarray(_logits(5)), -1))
    _close(tv.seg_loss_v2(T(logits), T(lab)), jv.seg_loss_v2(jnp.asarray(logits),
                                                             jnp.asarray(lab)))
    _close(tv.seg_weightloss(T(logits), T(lab), T(wts), fg_alpha=0.3),
           jv.seg_weightloss(jnp.asarray(logits), jnp.asarray(lab), jnp.asarray(wts),
                             fg_alpha=0.3))
    _close(tv.seg_softloss_v2(T(logits), T(probs)),
           jv.seg_softloss_v2(jnp.asarray(logits), jnp.asarray(probs)))
    _close(tv.seg_softloss(T(logits), T(probs), fg_alpha=0.4),
           jv.seg_softloss(jnp.asarray(logits), jnp.asarray(probs), fg_alpha=0.4))


def test_seg_get_pseudo_and_onehot_match_jax():
    logits = _logits(6)
    np.testing.assert_array_equal(tv.seg_get_pseudo(T(logits), greater=1.5).numpy(),
                                  np.asarray(jv.seg_get_pseudo(jnp.asarray(logits), 1.5)))
    lab = np.random.default_rng(7).integers(0, C, (B, H, W)).astype(np.int32)
    np.testing.assert_array_equal(tv.mask_to_onehot(T(lab), C).numpy(),
                                  np.asarray(jv.mask_to_onehot(jnp.asarray(lab), C)))


def _fake_forward(xp):
    """A deterministic 'model' (tests/test_variants.py), for both packages:
    CAMs from channel mixes, seg from shifts, cls from spatial means."""
    def fwd(x):
        r = x.astype(xp.float32) if xp is jnp else x.float()
        cam = xp.stack([r[..., 0], r[..., 1] - r[..., 2]], -1)
        seg = xp.stack([r[..., 2], r[..., 0] * 0.5, -r[..., 1]], -1)
        mean = r.mean((1, 2)) if xp is jnp else r.mean(dim=(1, 2))
        return {"cam": cam, "cam_aux": cam * 0.5 + 0.1, "seg": seg,
                "cls": mean[:, :2], "cls_aux": mean[:, 1:3]}
    return fwd


def _imgs(seed=8):
    return np.random.default_rng(seed).normal(size=(B, 16, 16, 3)).astype(np.float32)


@pytest.mark.parametrize("cam_fuse,seg_fuse", [(("max", "sum"), ("sum", "sum")),
                                               (("max", "sum"), ("max", "sum")),
                                               (("sum", "max"), ("max", "max"))])
def test_multi_scale_camseg_v2_matches_jax(cam_fuse, seg_fuse):
    x = _imgs()
    ours = tv.multi_scale_camseg_v2(_fake_forward(torch), T(x), (1.0, 0.5, 0.75),
                                    cam_fuse=cam_fuse, seg_fuse=seg_fuse)
    ref = jv.multi_scale_camseg_v2(_fake_forward(jnp), jnp.asarray(x), (1.0, 0.5, 0.75),
                                   cam_fuse=cam_fuse, seg_fuse=seg_fuse)
    for a, r, k in zip(ours, ref, ("cam", "cam_aux", "seg")):
        _close(a, r, atol=1e-5, msg=k)


def test_multi_scale_v2_max_sum_equals_the_live_fuse():
    """v2 with ('max', 'sum') for CAM and ('sum', 'sum') for seg is the live
    multi_scale_camseg (tests/test_variants.py:116), in the port too."""
    x = T(_imgs(9))
    cam_l, aux_l, seg_l = tpseudo.multi_scale_camseg(_fake_forward(torch), x, (1.0, 0.5))
    cam_v, aux_v, seg_v = tv.multi_scale_camseg_v2(_fake_forward(torch), x, (1.0, 0.5),
                                                   cam_fuse=("max", "sum"),
                                                   seg_fuse=("sum", "sum"))
    for a, r in ((cam_l, cam_v), (aux_l, aux_v), (seg_l, seg_v)):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)


def test_multi_scale_v4_seg_cls_match_jax():
    x = _imgs(10)
    cls_label = np.asarray([[1.0, 0.0], [1.0, 1.0]], np.float32)
    ours = tv.multi_scale_camseg_v4(_fake_forward(torch), T(x), (1.0, 0.5), T(cls_label))
    ref = jv.multi_scale_camseg_v4(_fake_forward(jnp), jnp.asarray(x), (1.0, 0.5),
                                   jnp.asarray(cls_label))
    for a, r, k in zip(ours, ref, ("cam", "cam_aux", "seg")):
        _close(a, r, atol=1e-5, msg=k)
    seg_t = tv.multi_scale_seg(lambda a: _fake_forward(torch)(a)["seg"], T(x), (1.0, 0.5))
    seg_j = jv.multi_scale_seg(lambda a: _fake_forward(jnp)(a)["seg"], jnp.asarray(x),
                               (1.0, 0.5))
    _close(seg_t, seg_j, atol=1e-5)
    cls_t = tv.multi_scale_cls(lambda a: _fake_forward(torch)(a)["cls"], T(x), (1.0, 0.5))
    cls_j = jv.multi_scale_cls(lambda a: _fake_forward(jnp)(a)["cls"], jnp.asarray(x),
                               (1.0, 0.5))
    _close(cls_t, cls_j, atol=1e-5)


# ---------------------------------------------------------------------------
# ops and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
def test_resize_dispatcher_matches_jax(method):
    x = np.random.default_rng(11).normal(size=(2, 9, 13, 3)).astype(np.float32)
    for size in ((18, 7), (9, 13)):
        _close(resize(T(x), size, method), jresize(jnp.asarray(x), size, method),
               rtol=1e-5, atol=1e-5, msg=f"{method} {size}")
    # NHWC: on a 3-d array JAX's nearest resize reads HWC, the port's NHW
    lab = np.random.default_rng(12).integers(0, 21, (2, 9, 13, 1)).astype(np.int32)
    if method == "nearest":  # integer label maps keep their values exactly
        np.testing.assert_array_equal(resize(T(lab), (18, 7), method).numpy(),
                                      np.asarray(jresize(jnp.asarray(lab), (18, 7), method)))
    with pytest.raises(ValueError):
        resize(T(x), (4, 4), "area")


@pytest.mark.parametrize("ignore", [False, True])
def test_evaluator_matches_jax(ignore):
    rng = np.random.default_rng(3)
    n = 5
    gt = rng.integers(0, n, size=(2, 20, 20)).astype(np.int64)
    gt[0, :3, :3] = 255
    pred = rng.integers(0, n, size=(2, 20, 20)).astype(np.int64)
    ours, ref = Evaluator(n, ignore=ignore), JEvaluator(n, ignore=ignore)
    for i in range(2):
        ours.add_batch(gt[i], pred[i])
        ref.add_batch(gt[i], pred[i])
    np.testing.assert_array_equal(ours.confusion_matrix, ref.confusion_matrix)
    for name in ("Pixel_Accuracy", "Pixel_Accuracy_Class", "Mean_Intersection_over_Union",
                 "Frequency_Weighted_Intersection_over_Union", "Precision_Recall"):
        a, r = getattr(ours, name)(), getattr(ref, name)()
        for x, y in zip(np.atleast_1d(np.asarray(a, dtype=object)),
                        np.atleast_1d(np.asarray(r, dtype=object))):
            np.testing.assert_array_equal(np.asarray(x, np.float64), np.asarray(y, np.float64))
    ours.reset()
    assert ours.confusion_matrix.sum() == 0


def test_lattice_gaussian_batch_cpu_matches_jax_and_per_image():
    rng = np.random.default_rng(13)
    feats = (rng.random((3, 200, 5)) * 4).astype(np.float32)
    vals = rng.random((3, 200, 4)).astype(np.float32)
    ours = lattice_gaussian_batch_cpu(feats, vals)
    np.testing.assert_allclose(ours, j_lattice_batch(feats, vals), rtol=1e-6, atol=1e-7)
    for i in range(3):
        np.testing.assert_allclose(ours[i], lattice_gaussian_cpu(feats[i], vals[i]),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# data/imutils.py
# ---------------------------------------------------------------------------

def _pil(seed, h, w, mode="RGB"):
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if mode == "RGB" else (h, w)
    return Image.fromarray(rng.integers(0, 256 if mode == "RGB" else 5, shape, np.uint8))


def test_imutils_transforms_match_jax():
    img = _pil(1, 60, 90)
    arr = np.asarray(img)
    lab = np.random.default_rng(2).integers(0, 5, (60, 90), np.uint8)
    for mod in (tim, jim):  # the same seeded draws through both packages
        rng = np.random.default_rng(0)
        out = dict(
            norm=mod.normalize_img(arr),
            long=np.asarray(mod.random_resize_long(rng, img, 100, 120)),
            fixed=np.asarray(mod.fix_scale_crop(img, 48)),
            box=mod.get_random_crop_box(rng, arr.shape[:2], 48),
            crops=mod.random_crop(rng, [img, arr, lab], 48, [0, 0, 255]),
            center=mod.center_crop(arr, 100, default_value=7),
            center2=mod.center_crop(arr, 40),
            pool=mod.avg_pool2d(arr.astype(np.float32), 4),
            nearest=mod.rescale_nearest(lab, 0.5),
            scalecrop=mod.random_scale_crop(rng, _pil(3, 40, 60), _pil(4, 40, 60, "L"),
                                            base_size=48, crop_size=48, fill=254),
            chw=mod.hwc_to_chw(arr),
        )
        out["withbox"] = mod.crop_with_box(arr, out["box"])
        if mod is tim:
            ours = out
    for k, r in out.items():
        a = ours[k]
        if isinstance(r, (list, tuple)) and not isinstance(r[0], (int, np.integer)):
            for x, y in zip(a, r):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(r), err_msg=k)


def test_imutils_crf_wrappers_match_jax():
    rng = np.random.default_rng(0)
    h, w, c = 24, 30, 4
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    logits = rng.normal(size=(c, h, w)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(0, keepdims=True)
    for name in ("crf_inference", "crf_inference_inf"):
        ours = getattr(tim, name)(img, probs, t=2, labels=c)
        assert ours.shape == (c, h, w)
        np.testing.assert_allclose(ours, getattr(jim, name)(img, probs, t=2, labels=c),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    labels = rng.integers(0, c, (h, w)).astype(np.int32)
    np.testing.assert_array_equal(tim.crf_inference_label(img, labels, t=2, n_labels=c),
                                  jim.crf_inference_label(img, labels, t=2, n_labels=c))


def test_imutils_crf_raises_where_the_native_build_fails(monkeypatch):
    """No numpy fallback in the port: a failed native build raises."""
    from cosa_tpu_torch.native import build

    def broken():
        raise RuntimeError("g++ failed to build the native lattice")

    monkeypatch.setattr(build, "load_native", broken)
    img = np.zeros((6, 6, 3), np.uint8)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tim.crf_inference(img, np.full((2, 6, 6), 0.5, np.float32), t=1, labels=2)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        rrm.crf_with_alpha(img, {0: np.full((6, 6), 0.5, np.float32)}, alpha=4, t=1)


# ---------------------------------------------------------------------------
# utils/rrm.py
# ---------------------------------------------------------------------------

def _rand_img(rng, h=24, w=24):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


def test_crf_with_alpha_and_seg_label_match_jax():
    rng = np.random.default_rng(2)
    img = _rand_img(rng)
    cams = {3: rng.random((24, 24)).astype(np.float32),
            11: rng.random((24, 24)).astype(np.float32)}
    np.testing.assert_allclose(rrm.crf_with_alpha(img, cams, alpha=4, t=2),
                               jrrm.crf_with_alpha(img, cams, alpha=4, t=2),
                               rtol=1e-6, atol=1e-6)
    n_fg = 20
    cam_label = np.zeros(n_fg)
    cam_label[[2, 7]] = 1
    norm_cam = np.zeros((n_fg, 24, 24), np.float32)
    yy, xx = np.mgrid[0:24, 0:24]
    for c in (2, 7):
        cy, cx = rng.integers(6, 18, 2)
        norm_cam[c] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 30.0)
        norm_cam[c] /= norm_cam[c].max()
    np.testing.assert_array_equal(rrm.compute_seg_label(img, cam_label, norm_cam),
                                  jrrm.compute_seg_label(img, cam_label, norm_cam))


def test_cam2seglabel_matches_jax():
    rng = np.random.default_rng(3)
    imgs = np.stack([_rand_img(rng), _rand_img(rng)])
    cam = rng.random((2, 6, 6, 20)).astype(np.float32)
    label = np.zeros((2, 20), np.float32)
    label[0, 4] = 1
    label[1, [1, 9]] = 1
    ours = rrm.cam2seglabel(T(cam), T(label), imgs)
    ref = jrrm.cam2seglabel(jnp.asarray(cam), jnp.asarray(label), imgs)
    assert ours.shape == (2, 24, 24)
    # the CAMs upsample in f32 in both packages, 3e-6 of the range apart:
    # a label may flip only where a class plane ties its threshold
    assert (ours != ref).mean() <= 2e-3, (ours != ref).mean()


@pytest.mark.parametrize("filter_kind", ["rff", "exact"])
def test_compute_joint_loss_value_and_grad_match_jax(filter_kind):
    rng = np.random.default_rng(4)
    b, h, w, c = 2, 16, 16, 21
    logits = rng.standard_normal((b, 8, 8, c)).astype(np.float32)
    label = rng.integers(0, c, (b, h, w)).astype(np.int32)
    label[0, :3] = 255
    crop = np.zeros((b, h, w), np.float32)
    crop[0, 2:14, 1:15] = 1.0
    crop[1, 0:16, 5:16] = 1.0
    imgs = (rng.standard_normal((b, h, w, 3)) * 0.5).astype(np.float32)
    kw = dict(energy_weight=1.0, filter_kind=filter_kind)

    def jloss(lg):
        ce, dl = jrrm.compute_joint_loss(jnp.asarray(imgs), lg, jnp.asarray(label),
                                         jnp.asarray(crop), **kw)
        return ce + dl, (ce, dl)

    (_, (ce_j, dl_j)), g_j = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    lg = T(logits).requires_grad_(True)
    ce_t, dl_t = rrm.compute_joint_loss(T(imgs), lg, T(label), T(crop), **kw)
    (g_t,) = torch.autograd.grad(ce_t + dl_t, lg)
    _close(ce_t, ce_j, rtol=1e-5)
    _close(dl_t, dl_j, rtol=1e-4, atol=0)
    g_j = np.asarray(g_j)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max()


def test_compute_cos_and_dis_match_jax():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((5, 8)).astype(np.float32)
    c = rng.standard_normal((3, 8)).astype(np.float32)
    _close(rrm.compute_cos(T(a), T(c)), jrrm.compute_cos(jnp.asarray(a), jnp.asarray(c)))
    for case in ("mixed", "fg_only", "bg_only", "one_image_no_bg"):
        feat = rng.standard_normal((2, 6, 6, 16)).astype(np.float32)
        seg = rng.standard_normal((2, 6, 6, 21)).astype(np.float32)
        if case == "fg_only":
            seg[..., 0] -= 100.0
        elif case == "bg_only":
            seg[..., 0] += 100.0
        elif case == "one_image_no_bg":
            seg[0, ..., 0] -= 100.0
            seg[1, ..., 0] += 100.0
        ours = rrm.compute_dis_no_batch(T(seg), T(feat))
        ref = jrrm.compute_dis_no_batch(jnp.asarray(seg), jnp.asarray(feat))
        assert ours.shape == (1,)
        _close(ours, np.asarray(ref).reshape(-1), rtol=1e-5, msg=case)


def test_rrm_data_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    label = rng.integers(0, 30, (7, 5, 1, 2)).astype(np.float64)
    _close(rrm.resize_label_batch(label, 12), jrrm.resize_label_batch(label, 12), atol=1e-4)
    img = rng.random((20, 30, 3)).astype(np.float32)
    small = rng.random((10, 8, 3)).astype(np.float32)
    for src in (img, small):
        a = rrm.random_crop_with_mask(src, 16, np.random.default_rng(1))
        r = jrrm.random_crop_with_mask(src, 16, np.random.default_rng(1))
        for x, y in zip(a, r):
            np.testing.assert_array_equal(x, y)
    u8 = _rand_img(rng, 9, 14)
    np.testing.assert_array_equal(rrm.scale_im(u8, 0.7), jrrm.scale_im(u8, 0.7))
    np.testing.assert_array_equal(rrm.scale_gt(u8[..., 0], 1.3), jrrm.scale_gt(u8[..., 0], 1.3))
    np.testing.assert_array_equal(rrm.flip(u8, 0.9), jrrm.flip(u8, 0.9))

    names = ["a", "b", "c"]
    for n in names:
        Image.fromarray(_rand_img(rng, 40, 52)).save(tmp_path / f"{n}.jpg")
    labels = {n: rng.integers(0, 2, 20).astype(np.float32) for n in names}
    ours = rrm.get_data_from_chunk_v2(names, str(tmp_path), 32, labels, np.random.default_rng(5))
    ref = jrrm.get_data_from_chunk_v2(names, str(tmp_path), 32, labels, np.random.default_rng(5))
    for x, y in zip(ours, ref):
        np.testing.assert_array_equal(x, y)
    p = tmp_path / "list.txt"
    p.write_text("x\ny\nz")
    assert rrm.read_file(str(p)) == jrrm.read_file(str(p)) == ["x", "y", "z"]
    assert [list(c) for c in rrm.chunker(list("abcde"), 2)] == [["a", "b"], ["c", "d"], ["e"]]


def test_rrm_poly_sgd_matches_optax():
    """The schedule against the JAX package's in f32, and three steps of the
    torch SGD with momentum = weight_decay against its optax transform."""
    for s in [0, 1, 25, 49, 50, 75, 99, 100, 150]:
        assert rrm.rrm_poly_sgd_schedule(0.01, 100)(s) == pytest.approx(
            float(jrrm.rrm_poly_sgd_schedule(0.01, 100)(s)), rel=1e-6)
    w = np.array([1.0, -2.0, 3.0], np.float32)
    g = np.array([0.5, 0.25, -1.0], np.float32)
    tx = jrrm.rrm_poly_sgd(0.01, 1e-4, max_step=100)
    wj, state = jnp.asarray(w), tx.init(jnp.asarray(w))
    tw = torch.nn.Parameter(T(w.copy()))
    opt = rrm.rrm_poly_sgd([tw], 0.01, 1e-4, max_step=100)
    assert opt.param_groups[0]["momentum"] == 1e-4 and opt.param_groups[0]["weight_decay"] == 0
    for k in range(3):
        up, state = tx.update(jnp.asarray(g * (k + 1)), state)
        wj = optax.apply_updates(wj, up)
        tw.grad = T(g * (k + 1))
        opt.step()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(wj), rtol=0, atol=1e-7)
