"""PyTorch port vs the JAX package: the pseudo-label pipeline, the
test-split submission and the evaluation visuals.

A miniature VOC tree on disk (3 val images with masks, 3 test images, one
of them larger than the 500 canvas) feeds both packages; the same JAX init
is carried into the port with ``state_dict_from_jax``.

Tolerances: the visualize functions write byte-equal files from the same
arrays; the pipeline's CAM ``.npy`` within 1e-5 absolute; pseudo masks,
submission labels and the evaluation's seg PNGs equal on >= 99.9% of the
pixels (f32 sums in another order move near-ties); mIoU within 1e-3; the
evaluation's CAM overlays within 2 of 255 on >= 99.9% of the values (the
jet map truncates to uint8)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import cosa_tpu.utils.visualize as jax_vis
from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.data.loader import build_test_dataset as jax_test_dataset
from cosa_tpu.data.loader import build_val_dataset as jax_val_dataset
from cosa_tpu.eval.engine import evaluate as jax_evaluate
from cosa_tpu.eval.pseudo_pipeline import generate_pseudo_labels as jax_pseudo
from cosa_tpu.eval.submit import dump_submission as jax_dump_submission
from cosa_tpu.models import build_model as jax_build_model
from cosa_tpu.ops.resize import np_resize_bilinear as jax_np_resize_bilinear
import cosa_tpu_torch.utils.visualize as vis
from cosa_tpu_torch.cli import make_pseudo
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.data.loader import build_test_dataset, build_val_dataset
from cosa_tpu_torch.eval.engine import evaluate
from cosa_tpu_torch.eval.pseudo_pipeline import generate_pseudo_labels
from cosa_tpu_torch.eval.submit import dump_submission, submission_dir
from cosa_tpu_torch.models.convert import state_dict_from_jax
from cosa_tpu_torch.models.network import build_model
from cosa_tpu_torch.ops.resize import np_resize_bilinear
from cosa_tpu_torch.train.loop import finaleval

VAL_SIZES = [(200, 240), (180, 260), (230, 210)]
TEST_SIZES = [(240, 300), (520, 260), (200, 220)]


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    """JPEGImages + palette SegmentationClassAug masks + JPEGImages_test,
    and a split dir with val/test lists and the class-label dict. Each val
    image holds two flat rectangles of its classes on noise."""
    root = tmp_path_factory.mktemp("voc")
    for d in ("JPEGImages", "SegmentationClassAug", "JPEGImages_test", "splits/voc"):
        (root / d).mkdir(parents=True)
    rng = np.random.default_rng(0)
    names, labels = [], {}
    for i, (h, w) in enumerate(VAL_SIZES):
        name = f"2007_{i:06d}"
        names.append(name)
        img = rng.integers(60, 200, (h, w, 3)).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        oh = np.zeros(20, np.uint8)
        for c, (y0, x0) in zip((i + 1, i + 5), ((20, 30), (100, 120))):
            img[y0:y0 + 70, x0:x0 + 80] = (40 * c) % 256, 200, (90 * c) % 256
            mask[y0:y0 + 70, x0:x0 + 80] = c
            oh[c - 1] = 1
        labels[name] = oh
        Image.fromarray(img).save(root / "JPEGImages" / f"{name}.jpg")
        vis.save_seg(mask, str(root / "SegmentationClassAug" / f"{name}.png"))
    test_names = [f"2008_{i:06d}" for i in range(len(TEST_SIZES))]
    for name, (h, w) in zip(test_names, TEST_SIZES):
        img = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        Image.fromarray(img).save(root / "JPEGImages_test" / f"{name}.jpg")
    (root / "splits/voc/val.txt").write_text("\n".join(names))
    (root / "splits/voc/train_aug.txt").write_text("\n".join(names))
    (root / "splits/voc/test.txt").write_text("\n".join(test_names))
    np.save(root / "splits/voc/cls_labels_onehot.npy", labels)
    return str(root)


def _cfgs(root, **kw):
    base = dict(data_root=root, split_dir=os.path.join(root, "splits"),
                backbone="vit_tiny_test", crop_size=64, mixed_precision=False,
                flash_attention=False, eval_scales=(1.0, 0.5), pseudo_scales=(1.0, 0.5),
                eval_batch=2, crf_reduce=8, par_iters=2, par_dilations=(1, 2))
    base.update(kw)
    return jax_preset("VOC12", **base), torch_preset("VOC12", **base)


def _models(cfg_j, cfg_t):
    model_j = jax_build_model(cfg_j)
    params = model_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    model_t = build_model(cfg_t, "cpu")
    model_t.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return model_j, params, model_t


def _agree(a, b):
    assert a.shape == b.shape
    return float((a == b).mean())


def test_np_resize_bilinear_equals_jax():
    x = np.random.default_rng(1).random((37, 41, 5)).astype(np.float32)
    for size in ((60, 23), (37, 41), (12, 90)):
        np.testing.assert_array_equal(np_resize_bilinear(x, size),
                                      jax_np_resize_bilinear(x, size))
    np.testing.assert_array_equal(np_resize_bilinear(x[..., 0], (50, 50)),
                                  jax_np_resize_bilinear(x[..., 0], (50, 50)))


def test_visualize_writes_byte_equal_files(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    cams = rng.random((30, 40, 20)).astype(np.float32)
    seg = rng.integers(0, 21, (30, 40)).astype(np.uint8)
    seg81 = rng.integers(0, 81, (30, 40)).astype(np.uint8)
    gt = rng.integers(0, 21, (30, 40)).astype(np.uint8)
    cls = np.zeros(20, np.float32)
    cls[[2, 7]] = 1
    names = [f"c{i}" for i in range(21)]
    np.testing.assert_array_equal(vis.voc_palette(256), jax_vis.voc_palette(256))
    np.testing.assert_array_equal(vis.spectral_palette(81), jax_vis.spectral_palette(81))
    for mod, d in ((vis, tmp_path / "t"), (jax_vis, tmp_path / "j")):
        d.mkdir()
        mod.save_seg(seg, str(d / "seg21.png"), 21)
        mod.save_seg(seg81, str(d / "seg81.png"), 81)
        mod.save_cam_on_image(img, cams[..., 3], str(d / "cam.png"))
        mod.save_merge(img, cams[..., 3], gt == 3, seg == 3, str(d / "merge.png"))
        mod.dump_eval_visuals(str(d / "dump"), "im", img, seg, cams, gt, cls, names, 21)
    files = sorted(os.path.relpath(os.path.join(p, f), tmp_path / "t")
                   for p, _, fs in os.walk(tmp_path / "t") for f in fs)
    assert len(files) == 4 + 5  # 4 single files; dump: 1 seg + 2 cam + 2 merged
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


@pytest.mark.parametrize("usepar,use_crf", [(False, False), (True, False), (False, True)],
                         ids=["cam", "par", "native-crf"])
def test_pseudo_pipeline_matches_jax(voc_tree, tmp_path, usepar, use_crf):
    """The first 2 val images. Under crf_backend "device" the JAX pipeline
    takes the native C++ lattice (its build succeeds here), as the port's
    always does."""
    cfg_j, cfg_t = _cfgs(voc_tree, usepar=usepar)
    model_j, params, model_t = _models(cfg_j, cfg_t)
    out_j, out_t = tmp_path / "j", tmp_path / "t"
    ref = jax_pseudo(cfg_j, model_j, params, jax_val_dataset(cfg_j), str(out_j),
                     max_images=2, use_crf=use_crf)
    ours = generate_pseudo_labels(cfg_t, model_t, build_val_dataset(cfg_t), str(out_t),
                                  max_images=2, use_crf=use_crf, device="cpu")
    assert abs(ours["miou"] - ref["miou"]) <= 1e-3
    names = sorted(os.listdir(out_j / "mask"))
    assert names == sorted(os.listdir(out_t / "mask")) == ["2007_000000.png", "2007_000001.png"]
    for n, (h, w) in zip(names, VAL_SIZES):
        a = Image.open(out_t / "mask" / n)
        assert a.mode == "P"
        a, b = np.asarray(a), np.asarray(Image.open(out_j / "mask" / n))
        assert a.shape == (h, w)
        assert _agree(a, b) >= 0.999, n
        cam_t = np.load(out_t / "cam" / n.replace(".png", ".npy"))
        cam_j = np.load(out_j / "cam" / n.replace(".png", ".npy"))
        assert cam_t.shape == (64, 64, 20)
        assert np.abs(cam_t - cam_j).max() <= 1e-5, n


@pytest.mark.parametrize("backend", [None, "device", "native"])
def test_submission_matches_jax(voc_tree, tmp_path, backend):
    """No CRF, the device CRF on each batch's canvas (two canvases: 500
    and 640), and the native CRF at batch 1."""
    use_crf = backend is not None
    cfg_j, cfg_t = _cfgs(voc_tree, eval_split="test", crf_backend=backend or "device")
    model_j, params, model_t = _models(cfg_j, cfg_t)
    dst_j = jax_dump_submission(cfg_j, model_j, params, jax_test_dataset(cfg_j),
                                str(tmp_path / "j"), use_crf=use_crf)
    dst_t = dump_submission(cfg_t, model_t, build_test_dataset(cfg_t), str(tmp_path / "t"),
                            use_crf=use_crf, device="cpu")
    assert dst_t == submission_dir(str(tmp_path / "t"))
    assert dst_t.endswith(os.path.join("results", "VOC2012", "Segmentation", "comp6_test_cls"))
    for i, (h, w) in enumerate(TEST_SIZES):
        png = Image.open(os.path.join(dst_t, f"2008_{i:06d}.png"))
        assert png.mode == "P"
        a = np.asarray(png)
        assert a.shape == (h, w) and a.max() < 21
        b = np.asarray(Image.open(os.path.join(dst_j, f"2008_{i:06d}.png")))
        assert _agree(a, b) >= 0.999, i


def test_evaluate_save_dir_matches_jax(voc_tree, tmp_path):
    cfg_j, cfg_t = _cfgs(voc_tree)
    model_j, params, model_t = _models(cfg_j, cfg_t)
    d_j, d_t = tmp_path / "j", tmp_path / "t"
    ref = jax_evaluate(cfg_j, model_j, params, jax_val_dataset(cfg_j), save_dir=str(d_j))
    ours = evaluate(cfg_t, model_t, build_val_dataset(cfg_t), save_dir=str(d_t), device="cpu")
    assert abs(ours["Seg_vd"]["miou"] - ref["Seg_vd"]["miou"]) <= 1e-3
    files = sorted(os.path.relpath(os.path.join(p, f), d_t)
                   for p, _, fs in os.walk(d_t) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(p, f), d_j)
                           for p, _, fs in os.walk(d_j) for f in fs)
    assert len(files) == 3 * (1 + 2 + 2)  # per image: seg, 2 classes x (cam, merged)
    for f in files:
        a, b = np.asarray(Image.open(d_t / f)), np.asarray(Image.open(d_j / f))
        if f.startswith("seg"):
            assert _agree(a, b) >= 0.999, f
        else:
            close = np.abs(a.astype(int) - b.astype(int)) <= 2
            assert close.mean() >= 0.999, f


def test_finaleval_test_split_and_make_pseudo_cli(voc_tree, tmp_path, capsys):
    """The two entry points end to end on the CPU from a reference-key
    .pth: finaleval with eval_split "test" writes the submission, the
    make_pseudo CLI the val split's masks and CAMs."""
    pth = str(tmp_path / "w.pth")
    _, cfg_t = _cfgs(voc_tree)
    torch.save(build_model(cfg_t, "cpu", seed=5).state_dict(), pth)
    flags = ["--data_root", voc_tree, "--split_dir", os.path.join(voc_tree, "splits"),
             "--backbone", "vit_tiny_test", "--crop_size", "64", "--mixed_precision", "false",
             "--pretrained_path", pth, "--work_dir", str(tmp_path), "--device", "cpu"]
    _, cfg = _cfgs(voc_tree, eval_split="test", pretrained_path=pth, work_dir=str(tmp_path),
                   name="sub", crf_backend="native")
    res = finaleval(cfg, device="cpu")
    assert res["submission_dir"] == submission_dir(str(tmp_path / "sub"))
    assert len(os.listdir(res["submission_dir"])) == len(TEST_SIZES)
    make_pseudo.main(["pl", "--dataset", "VOC12", *flags, "--eval_scales", "1.0",
                      "--pseudo_scales", "1.0", "--use_crf", "--crf_backend", "native"])
    out = capsys.readouterr().out
    assert "native C++ lattice" in out and "'miou'" in out and "'iou'" not in out
    for sub, ext in (("mask", ".png"), ("cam", ".npy")):
        got = sorted(os.listdir(tmp_path / "pl" / "pseudo" / sub))
        assert got == [f"2007_{i:06d}{ext}" for i in range(len(VAL_SIZES))]
