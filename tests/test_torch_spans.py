"""PyTorch port: the trace spans (``utils/trace.py``). ``span`` costs a
shared do-nothing context with no profiler and is ``record_function``
under one; a profiled ``evaluate`` and a profiled train step hold every
span their code opens, as often as the module's docstring says."""

import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cosa_tpu_torch.config import preset_config
from cosa_tpu_torch.data import synthwsss
from cosa_tpu_torch.data.loader import build_val_dataset
from cosa_tpu_torch.eval.engine import evaluate
from cosa_tpu_torch.models.network import build_model
from cosa_tpu_torch.train.loop import train
from cosa_tpu_torch.train.state import create_train_state
from cosa_tpu_torch.train.step import build_train_step
from cosa_tpu_torch.utils.trace import span

STEP_SPANS = ("teacher_tta", "gmm", "pseudo_labels", "student_forward", "losses", "energy",
              "backward", "optimizer", "ema")
EVAL_SPANS = ("eval_load", "eval_prep", "eval_canvas", "eval_score", "eval_ap", "eval_dump")
TINY = dict(backbone="vit_tiny_test", crop_size=64, mixed_precision=False,
            flash_attention=False)


def _annotations(prof):
    """(name, start, end) of each profiled ``record_function`` span."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name in STEP_SPANS + EVAL_SPANS + ("tta_forward", "tta_fuse")]


def test_span_is_a_shared_nullcontext_without_a_profiler():
    off = span("eval_load")
    assert off is span("tta_fuse")
    with off, off:  # reusable and re-entrant
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = span("eval_load")
        assert isinstance(on, record_function)
        with on:
            pass
    assert span("eval_load") is off


def _val_tree(tmp_path):
    """A 4-image ShapesWSSS val tree and the VOC12 config that reads it."""
    root = str(tmp_path / "data")
    synthwsss.make_dataset(root, n_train=0, n_val=4, seed=5, size_range=(64, 96))
    return preset_config("VOC12", data_root=root, split_dir=os.path.join(root, "splits"),
                         eval_scales=(1.0, 0.5), eval_batch=2, crf_reduce=8, **TINY)


def test_profiled_evaluate_holds_each_span_once_a_batch(tmp_path):
    cfg = _val_tree(tmp_path)
    model = build_model(cfg, "cpu")
    val_ds = build_val_dataset(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = evaluate(cfg, model, val_ds, getcrf=True, threshold_filters=(0.3,),
                       save_dir=str(tmp_path / "visuals"), device="cpu")
    batches = 2
    counts = Counter(name for name, _, _ in _annotations(prof))
    for name in EVAL_SPANS:
        assert counts[name] == batches, name
    assert counts["tta_forward"] == batches * len(cfg.eval_scales)
    assert counts["tta_fuse"] >= batches * len(cfg.eval_scales)
    assert res["time"]["images"] == 4 and res["time"]["crf_seconds"] > 0
    assert len(os.listdir(str(tmp_path / "visuals"))) > 0


def test_profiled_train_step_keeps_the_step_spans_around_the_tta():
    cfg = preset_config("synthetic", num_classes=6, batch_size=2, pseudo_scales=(1.0, 0.5),
                        usegmm=True, queue_update_ratio=4, energy_convention=0.6, **TINY)
    state = create_train_state(cfg, "cpu")
    rng = np.random.default_rng(0)
    label = np.zeros((2, 5), np.float32)
    label[0, [0, 2]] = label[1, [1, 4]] = 1
    batch = dict(wimg=rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8),
                 simg=rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8),
                 cls_label=label, img_box=np.array([[0, 64, 0, 64], [4, 60, 2, 62]], np.int32))
    step = build_train_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    spans = _annotations(prof)
    counts = Counter(name for name, _, _ in spans)
    for name in STEP_SPANS:
        assert counts[name] == 1, name
    (tta_start, tta_end), = [(a, b) for name, a, b in spans if name == "teacher_tta"]
    inside = [name for name, a, b in spans if tta_start <= a and b <= tta_end]
    assert inside.count("tta_forward") == counts["tta_forward"] == len(cfg.pseudo_scales)
    assert inside.count("tta_fuse") == counts["tta_fuse"] >= len(cfg.pseudo_scales)


def test_training_loop_logs_the_data_wait_and_traces_its_spans(tmp_path):
    cfg = preset_config("synthetic", max_iters=2, eval_iters=100, log_iters=1, warmup_iters=1,
                        finalval=False, num_workers=2, work_dir=str(tmp_path), name="run",
                        profile_dir=str(tmp_path / "prof"), **TINY)
    res = train(cfg, device="cpu")
    assert all(r["data_wait_ms"] >= 0 for r in res["records"])
    with open(os.path.join(tmp_path, "prof", "trace_rank0.json")) as f:
        trace = f.read()
    for name in ("loader_wait", "to_device"):
        assert trace.count(f'"name": "{name}"') == 2, name
    with open(os.path.join(tmp_path, "run", "print.out")) as f:
        assert "data wait" in f.read()


@pytest.mark.cuda
def test_device_crf_is_timed_by_cuda_events(tmp_path):
    """On the card the device CRF's seconds come from CUDA events read when
    the pass ends: the same scores as a pass on the CPU, and a CRF time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = _val_tree(tmp_path)
    model = build_model(cfg, "cpu")
    res = {dev: evaluate(cfg, model.to(dev), build_val_dataset(cfg), getcrf=True, device=dev)
           for dev in ("cpu", "cuda")}
    assert 0 < res["cuda"]["time"]["crf_seconds"] < res["cuda"]["time"]["seconds"]
    for name in ("CAM", "Seg_vd", "Seg_crf"):
        assert abs(res["cuda"][name]["miou"] - res["cpu"][name]["miou"]) <= 0.02, name
