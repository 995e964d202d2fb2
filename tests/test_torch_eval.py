"""PyTorch port vs the JAX package: the scoring path (metrics,
seg_validation, the device DenseCRF, evaluate).

Tolerances: the confusion matrices and scores of the metrics are exact;
seg_validation is exact; the CRF's labels agree on >= 99.9% of the valid
pixels (f32 sums in another order move near-ties); evaluate's classification
mAPs agree within 1e-5, each confusion matrix within 0.1% of its counted
pixels (argmax flips at near-ties), each mIoU within 1e-3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cosa_tpu.eval.engine as jax_engine
from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.data.loader import build_val_dataset as jax_val_dataset
from cosa_tpu.eval import crf as jax_crf
from cosa_tpu.eval.metrics import fast_hist as jax_fast_hist
from cosa_tpu.eval.metrics import jax_hist
from cosa_tpu.eval.metrics import pseudo_scores as jax_pseudo_scores
from cosa_tpu.eval.metrics import scores as jax_scores
from cosa_tpu.eval.metrics import scores_from_hist as jax_scores_from_hist
from cosa_tpu.models import build_model as jax_build_model
from cosa_tpu.objectives.pseudo import seg_validation as jax_seg_validation
import cosa_tpu_torch.eval.engine as engine
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.data.loader import build_val_dataset
from cosa_tpu_torch.eval import crf
from cosa_tpu_torch.eval.metrics import (
    fast_hist,
    pseudo_scores,
    scores,
    scores_from_hist,
    torch_hist,
)
from cosa_tpu_torch.models.convert import state_dict_from_jax
from cosa_tpu_torch.models.network import build_model
from cosa_tpu_torch.objectives.pseudo import seg_validation


def test_hists_and_scores_equal_jax():
    rng = np.random.default_rng(0)
    gt = rng.integers(0, 21, size=(3, 37, 41)).astype(np.int64)
    gt[0, :5] = 255  # ignore
    pred = rng.integers(0, 23, size=(3, 37, 41)).astype(np.int64)  # 21, 22 clip to 20
    ref = np.asarray(jax_hist(jnp.asarray(gt), jnp.asarray(pred), 21))
    ours = torch_hist(torch.from_numpy(gt), torch.from_numpy(pred), 21)
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), ref)
    ok = pred < 21
    np.testing.assert_array_equal(fast_hist(gt[ok], pred[ok], 21),
                                  jax_fast_hist(gt[ok], pred[ok], 21))
    a, b = scores_from_hist(ref), jax_scores_from_hist(ref)
    for k in ("pAcc", "mAcc", "miou"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(list(a["iou"].values()), list(b["iou"].values()))


def test_scores_and_pseudo_scores_equal_jax():
    """Per-image label lists; pseudo labels carry the ignore band (255),
    which drops the pixel from scoring."""
    rng = np.random.default_rng(2)
    gts = [rng.integers(0, 21, size=(9, 11)) for _ in range(3)]
    gts[1][:2] = 255
    preds = [rng.integers(0, 21, size=(9, 11)) for _ in range(3)]
    pseudo = [np.where(rng.random((9, 11)) < 0.2, 255, p) for p in preds]
    for ours, ref, lp in ((scores, jax_scores, preds), (pseudo_scores, jax_pseudo_scores, pseudo)):
        a, b = ours(gts, lp, 21), ref(gts, lp, 21)
        for k in ("pAcc", "mAcc", "miou"):
            assert a[k] == b[k], k
        np.testing.assert_array_equal(list(a["iou"].values()), list(b["iou"].values()))


def test_seg_validation_equals_jax():
    rng = np.random.default_rng(1)
    seg = rng.standard_normal((2, 5, 6, 6)).astype(np.float32)
    cls = np.array([[1, 0, 0, 1, 0], [0, 0, 1, 0, 0]], np.float32)
    ref = np.asarray(jax_seg_validation(jnp.asarray(seg), jnp.asarray(cls)))
    ours = seg_validation(torch.from_numpy(seg), torch.from_numpy(cls)).numpy()
    np.testing.assert_array_equal(ours, ref)


def _crf_inputs(p=64, h=52, w=40, c=5):
    """A blob image on a zero canvas, noisy class probabilities, and the
    valid mask of the (h, w) image at the canvas's top left."""
    rng = np.random.default_rng(3)
    img = np.zeros((1, p, p, 3), np.float32)
    img[0, :h, :w] = rng.integers(80, 176, (h, w, 3))
    img[0, 10:30, 8:25] = [200, 40, 40]
    logits = rng.standard_normal((1, p, p, c)).astype(np.float32)
    logits[0, 10:30, 8:25, 2] += 1.0
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    valid = np.zeros((1, p, p), np.float32)
    valid[0, :h, :w] = 1.0
    return img, probs.astype(np.float32), valid


@pytest.mark.parametrize("reduce", [2, 1])
def test_crf_labels_match_jax(reduce):
    cfg_j = jax_preset("synthetic", crf_reduce=reduce)
    cfg_t = torch_preset("synthetic", crf_reduce=reduce)
    img, probs, valid = _crf_inputs()
    ref = np.asarray(jax_crf.crf_labels_device(
        cfg_j, jnp.asarray(img), jnp.asarray(probs), jnp.asarray(valid)))
    ours = crf.crf_labels_device(cfg_t, torch.from_numpy(img), torch.from_numpy(probs),
                                 torch.from_numpy(valid))
    assert ours.dtype == torch.int32 and ours.shape == ref.shape
    v = valid > 0
    assert (ours.numpy()[v] == ref[v]).mean() >= 0.999
    assert (ours.numpy()[v] != probs.argmax(-1)[v]).any()  # the CRF changed labels


def test_crf_filters_match_jax():
    """The spatial transform against the JAX package's, within 1e-5 of its
    largest value; the chunked bilateral product against the JAX package's
    and against float64, within 1e-3 of the largest value: squared
    distances of features up to 50 cancel terms near 7.5e3 in f32, which
    leaves both packages about 5e-4 from float64."""
    rng = np.random.default_rng(4)
    q = rng.random((24, 20, 3)).astype(np.float32)
    ref = np.asarray(jax_crf._spatial_filter(jnp.asarray(q), 1.0))
    ours = crf._spatial_filter(torch.from_numpy(q), 1.0).numpy()
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()
    feats = (rng.random((300, 5)) * [5, 5, 50, 50, 50]).astype(np.float32)
    vals = rng.random((300, 4)).astype(np.float32)
    f64 = feats.astype(np.float64)
    exact = np.exp(-0.5 * ((f64[:, None] - f64[None]) ** 2).sum(-1)) @ vals
    ref = np.asarray(jax_crf._bilateral_exact_chunked(jnp.asarray(feats), jnp.asarray(vals), 128))
    ours = crf._bilateral_exact_chunked(torch.from_numpy(feats), torch.from_numpy(vals), 64)
    for other in (ref, exact):
        assert np.abs(ours.numpy() - other).max() <= 1e-3 * np.abs(exact).max()


def _record_hists(monkeypatch, module, fn):
    seen = []

    def wrapped(hist):
        seen.append(np.asarray(hist))
        return fn(hist)

    monkeypatch.setattr(module, "scores_from_hist", wrapped)
    return seen


def _evaluate_both(monkeypatch, **kw):
    """evaluate() of one JAX init through both packages, on the synthetic
    val split (5 images, crop 64, the default five eval scales, the device
    CRF at crf_reduce 8, one threshold filter), held to the tolerances
    above."""
    kw = dict(crop_size=64, mixed_precision=False, flash_attention=False, eval_batch=2,
              crf_reduce=8, **kw)
    cfg_j, cfg_t = jax_preset("synthetic", **kw), torch_preset("synthetic", **kw)
    model_j = jax_build_model(cfg_j)
    params = model_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    model_t = build_model(cfg_t, "cpu")
    model_t.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))

    h_j = _record_hists(monkeypatch, jax_engine, jax_engine.scores_from_hist)
    h_t = _record_hists(monkeypatch, engine, engine.scores_from_hist)
    args = dict(getcrf=True, threshold_filters=(0.3,), max_images=5)
    ref = jax_engine.evaluate(cfg_j, model_j, params, jax_val_dataset(cfg_j), **args)
    ours = engine.evaluate(cfg_t, model_t, build_val_dataset(cfg_t), device="cpu", **args)

    names = ["CAM", "aux_CAM", "Seg_ps", "Seg_vd", "cam_0.3", "camaux_0.3", "Seg_crf"]
    assert engine.score_names(ours) == names
    assert ours["time"]["images"] == 5
    np.testing.assert_allclose(ours["cls_aps"], ref["cls_aps"], atol=1e-5)
    assert len(h_t) == len(h_j) == len(names)
    for name, a, b in zip(names, h_t, h_j):
        assert b.sum() > 0, name
        assert np.abs(a - b).sum() <= 1e-3 * b.sum(), name
        assert abs(ours[name]["miou"] - ref[name]["miou"]) <= 1e-3, name
    assert model_t.training  # evaluate puts the module's mode back


def test_evaluate_matches_jax(monkeypatch):
    _evaluate_both(monkeypatch, backbone="vit_tiny_test")


def test_evaluate_swin_matches_jax(monkeypatch):
    """The zoo's co-training family: a Swin model's CAM (/32) and aux CAM
    (/16) at two sizes on the canvas; the 0.75 and 1.25 scales of crop 64
    pad its windows, the smallest stages are single windows."""
    _evaluate_both(monkeypatch, model="swinend2end", backbone="swin_tiny_test")
