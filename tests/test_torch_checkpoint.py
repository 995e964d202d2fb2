"""PyTorch port: checkpoints, resume, validation's best pick and the final
evaluation, end to end on the CPU at a tiny size (vit_tiny_test, crop 64,
f32).

A resumed run must equal the straight run bitwise (the CPU's arithmetic is
deterministic, and the loader replays the same batches); the best pick
follows the JAX package's rules (round to 2 decimals, the student wins
ties, then the teacher, then the best so far)."""

import json
import os

import numpy as np
import pytest
import torch

from cosa_tpu_torch.cli import evaluate as cli_evaluate
from cosa_tpu_torch.cli import train as cli_train
from cosa_tpu_torch.config import preset_config
from cosa_tpu_torch.data.loader import build_val_dataset
from cosa_tpu_torch.parallel.mesh import Mesh
from cosa_tpu_torch.train import checkpoint as ckpt
from cosa_tpu_torch.train import loop
from cosa_tpu_torch.train.state import create_train_state
from cosa_tpu_torch.utils.logging import MetricWriter


def _cfg(tmp_path, **kw):
    base = dict(backbone="vit_tiny_test", max_iters=4, eval_iters=2, log_iters=1,
                warmup_iters=1, fasteval=True, fasteval_n=2, eval_batch=2,
                eval_scales=(1.0, 0.5), finalval=False, num_workers=2,
                mixed_precision=False, crf_reduce=8, work_dir=str(tmp_path))
    base.update(kw)
    return preset_config("synthetic", **base)


def _assert_same_tensors(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_tensors(a[k], b[k], f"{what}.{k}")
        elif torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), f"{what}.{k}"
        else:
            assert a[k] == b[k], f"{what}.{k}"


def test_resume_reproduces_the_straight_run(tmp_path):
    straight = loop.train(_cfg(tmp_path, name="a"), device="cpu")
    loop.train(_cfg(tmp_path, name="b"), max_steps=2, device="cpu")
    ck_dir = os.path.join(tmp_path, "b", "ckpt")
    assert ckpt.latest_step(ck_dir) == 2
    resumed = loop.train(_cfg(tmp_path, name="c", resume=ck_dir), device="cpu")

    assert resumed["state"].step == straight["state"].step == 4
    assert [r["iter"] for r in resumed["records"]] == [3, 4]
    for r, s in zip(resumed["records"], straight["records"][2:]):
        for k in loop.LOSS_KEYS:
            assert r[k] == s[k], k
    a, b = straight["state"], resumed["state"]
    _assert_same_tensors(a.student.state_dict(), b.student.state_dict(), "student")
    _assert_same_tensors(a.teacher.state_dict(), b.teacher.state_dict(), "teacher")
    _assert_same_tensors(a.optimizer.opt.state_dict(), b.optimizer.opt.state_dict(), "opt")
    # checkpoint_keep=2: steps 2 and 4 of the straight run, and best weights
    out = os.path.join(tmp_path, "a")
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "step_00000002.pt", "step_00000004.pt"]
    assert os.path.exists(os.path.join(out, "best_seg", "params.pt"))
    with open(os.path.join(out, "log_val.txt")) as f:
        assert [ln for ln in f if ln.startswith("iters:")] == ["iters:1\n", "iters:3\n"]
    assert -1.0 < straight["best_seg"] <= 100.0


def test_checkpoint_keeps_the_newest_and_restores_a_file(tmp_path):
    cfg = _cfg(tmp_path)
    state = create_train_state(cfg, "cpu")
    for step in (1, 2, 3):
        state.step = step
        ckpt.save_state(str(tmp_path), state, step, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert not os.path.exists(os.path.join(tmp_path, "step_00000001.pt"))
    other = create_train_state(cfg.replace(seed=5), "cpu")
    ckpt.restore_state(os.path.join(tmp_path, "step_00000002.pt"), other)
    assert other.step == 2
    _assert_same_tensors(state.student.state_dict(), other.student.state_dict(), "student")
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def _res(seg, cam):
    iou = {i: 0.5 for i in range(21)}
    return {"CAM": {"miou": cam, "iou": iou}, "Seg_vd": {"miou": seg, "iou": iou},
            "cls_aps": (0.5, 0.5), "time": {"images": 2, "seconds": 1.0}}


def _saved(out, comment, state):
    path = os.path.join(out, f"best_{comment}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    sd = torch.load(os.path.join(path, "params.pt"), weights_only=True)
    model = state.student if meta["s_or_t"] == "s" else state.teacher
    _assert_same_tensors(sd, model.state_dict(), comment)
    return meta


def test_validation_best_pick_follows_the_jax_rules(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path)
    state = create_train_state(cfg, "cpu")
    out = str(tmp_path)
    rounds = iter([
        # student 41.23 ties the teacher's 41.23 after rounding: the student;
        # the teacher's CAM wins
        _res(0.412341, 0.30), _res(0.412251, 0.35),
        # seg: the student ties the best so far, and is saved again; CAM:
        # neither beats 35.00, nothing is saved
        _res(0.412349, 0.2), _res(0.40, 0.3499),
    ])
    monkeypatch.setattr(loop, "evaluate", lambda *a, **k: next(rounds))
    writer = MetricWriter(out)
    _, seg, cam = loop._run_validation(cfg, state, None, writer, 2, out, -1.0, -1.0, "cpu",
                                       Mesh())
    assert (seg, cam) == (41.23, 35.0)
    assert _saved(out, "seg", state) == dict(s_or_t="s", iter=2, result=41.23)
    assert _saved(out, "cam", state) == dict(s_or_t="t", iter=2, result=35.0)
    _, seg, cam = loop._run_validation(cfg, state, None, writer, 4, out, seg, cam, "cpu",
                                       Mesh())
    assert (seg, cam) == (41.23, 35.0)
    assert _saved(out, "seg", state)["iter"] == 4
    assert _saved(out, "cam", state)["iter"] == 2
    writer.close()
    with open(os.path.join(out, "log_val.txt")) as f:
        assert f.read().count("iters:") == 2


def test_emergency_checkpoint_on_a_failed_step(tmp_path, monkeypatch):
    real = loop.build_train_step

    def failing(cfg, mesh):
        step = real(cfg, mesh)

        def run(state, batch):
            if state.step == 1:
                raise RuntimeError("step failed")
            return step(state, batch)
        return run

    monkeypatch.setattr(loop, "build_train_step", failing)
    with pytest.raises(RuntimeError, match="step failed"):
        loop.train(_cfg(tmp_path, name="e"), device="cpu")
    path = os.path.join(tmp_path, "e", "ckpt_emergency")
    assert ckpt.latest_step(path) == 1


def test_cli_final_evaluation_scores_best_seg(tmp_path, monkeypatch):
    """cli.train with --finalval true, then cli.evaluate, on a val split cut
    to 2 images; finaleval loads best_seg's weights."""
    cut = lambda cfg: [build_val_dataset(cfg)[i] for i in (3, 17)]  # noqa: E731
    monkeypatch.setattr(loop, "build_test_dataset", cut)
    scored = []
    real_eval = loop.evaluate

    def spy(cfg, model, ds, **kw):
        scored.append((model, kw))
        return real_eval(cfg, model, ds, **kw)

    monkeypatch.setattr(loop, "evaluate", spy)
    args = ["f", "--dataset", "synthetic", "--backbone", "vit_tiny_test", "--max_iters", "2",
            "--eval_iters", "2", "--log_iters", "1", "--fasteval", "true", "--fasteval_n", "2",
            "--eval_batch", "2", "--eval_scales", "1.0", "0.5", "--mixed_precision", "false",
            "--crf_reduce", "8", "--num_workers", "2", "--work_dir", str(tmp_path),
            "--device", "cpu"]
    cli_train.main(args + ["--finalval", "true"])
    cli_evaluate.main(args)
    finals = [kw for _, kw in scored if kw.get("getcrf")]
    assert len(finals) == 2 and len(scored) == 4  # 2 validations, 2 final evaluations
    best = torch.load(os.path.join(tmp_path, "f", "best_seg", "params.pt"), weights_only=True)
    _assert_same_tensors(scored[-1][0].state_dict(), best, "best_seg")
    with open(os.path.join(tmp_path, "f", "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    finals = [r for r in recs if r["kind"] == "final"]
    assert len(finals) == 2 and finals[0]["images"] == 2
    for r in finals:
        for k in ("CAM", "Seg_vd", "Seg_crf"):
            assert 0.0 <= r[k] <= 1.0, k
    assert np.isfinite(finals[0]["crf_seconds"])
