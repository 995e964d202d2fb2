"""PyTorch port: the data loader against the JAX package's, and the
training loop end to end on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.data.loader import build_train_loader as jax_build_loader
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.data.loader import build_train_loader
from cosa_tpu_torch.eval.crf import crf_refine_host
from cosa_tpu_torch.models.network import build_model
from cosa_tpu_torch.parallel.mesh import Mesh, shard_module_
from cosa_tpu_torch.train.loop import train


def _tiny(**kw):
    base = dict(backbone="vit_tiny_test", max_iters=3, eval_iters=100, log_iters=1,
                warmup_iters=1, finalval=False, num_workers=2)
    base.update(kw)
    return torch_preset("synthetic", **base)


def test_loader_batches_bit_identical_to_jax():
    kw = dict(crop_size=64, seed=3)
    ours = build_train_loader(torch_preset("synthetic", **kw), 2, num_workers=2)
    ref = jax_build_loader(jax_preset("synthetic", **kw), 2, num_workers=2)
    try:
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    finally:
        ours.close()
        ref.close()


def test_train_three_steps_on_cpu_writes_metrics(tmp_path):
    cfg = _tiny(work_dir=str(tmp_path), name="run")
    res = train(cfg, device="cpu")
    assert len(res["records"]) == 3
    assert res["state"].step == 3
    lines = [json.loads(ln) for ln in open(os.path.join(tmp_path, "run", "metrics.jsonl"))]
    recs = [r for r in lines if r["kind"] == "train"]
    assert [r["iter"] for r in recs] == [1, 2, 3]
    for r in recs:
        for k in ("overall_loss", "cls_loss", "seg_loss", "cam_loss", "reg_loss", "lr"):
            assert np.isfinite(r[k]), k
    assert os.path.exists(os.path.join(tmp_path, "run", "print.out"))
    assert 0.2 < res["energy_convention"] < 1.5


def test_train_without_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        train(_tiny(work_dir=str(tmp_path)))


def test_unported_options_raise_up_front():
    # a layout the process group cannot hold, before any work: one process
    for kw in (dict(tp=2), dict(dp=2)):
        with pytest.raises(ValueError, match="world size"):
            train(_tiny(work_dir="unused", **kw), device="cpu")
    # the head-aligned qkv split: vit_tiny_test's 4 heads over 3 model ranks
    model = build_model(_tiny(), "cpu")
    with pytest.raises(ValueError, match="4 heads do not split over tp=3"):
        shard_module_(model, Mesh(world=3, tp=3))
    with pytest.raises(NotImplementedError, match="ViT-only"):
        _tiny(model="swinend2end", backbone="swin_tiny_test", teacher_int8=True)
    with pytest.raises(ValueError, match="native"):
        crf_refine_host(_tiny(crf_backend="device"), torch.zeros((4, 4, 3), dtype=torch.uint8),
                        torch.full((4, 4, 2), 0.5))
