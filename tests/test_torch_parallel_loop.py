"""PyTorch port: the training loop over a process group on the CPU (gloo).

  * dp=2: two ranks train two steps and validate at step 2; each rank's
    validation equals a one-process ``evaluate`` of the same weights (read
    back from the run's step-2 checkpoint) on every score and on
    ``cls_aps``: the data ranks score alternate images, their confusion
    matrices are summed and their per-image APs gathered. Both ranks log
    the same global metrics, and only rank 0 writes its profiler trace.
  * tp=2: a run of four steps with checkpoints at steps 2 and 4; its step-2
    checkpoint holds the unsharded state of a one-process run's step 2 (in
    the same head order: a consistent permutation of the heads would
    compute the same function), and one process resumed from it to step 4
    ends where the two-rank run ended: losses within 1e-4, weights within
    1e-5 of their largest value (floor 1e-3; lr 1e-9,
    tests/test_torch_parallel.py says why), the AdamW moments within 1e-4
    of theirs.
"""

import os

import numpy as np
import torch

from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.data.loader import build_val_dataset
from cosa_tpu_torch.eval.engine import evaluate
from cosa_tpu_torch.parallel.launch import spawn, train_worker
from cosa_tpu_torch.train import checkpoint as ckpt
from cosa_tpu_torch.train.loop import LOSS_KEYS, train
from cosa_tpu_torch.train.state import create_train_state

EVAL_N = 6


def _cfg(tmp_path, **kw):
    base = dict(backbone="vit_tiny_test", num_classes=6, crop_size=64, mixed_precision=False,
                flash_attention=False, max_iters=2, eval_iters=2, log_iters=1,
                warmup_iters=0, lr_warmup_iters=2, fasteval=True, fasteval_n=EVAL_N,
                eval_batch=1, eval_scales=(1.0, 0.5), finalval=False, num_workers=1,
                energy_convention=0.6, work_dir=str(tmp_path), name="run")
    base.update(kw)
    return torch_preset("synthetic", **base)


def test_dp2_validation_equals_one_process_evaluate(tmp_path):
    prof = str(tmp_path / "prof")
    cfg = _cfg(tmp_path, batch_size=1, dp=2, profile_dir=prof)
    outs = spawn(train_worker, 2, [cfg], "cpu")
    r0, r1 = outs[0][0], outs[1][0]
    assert [r["iter"] for r in r0["records"]] == [1, 2]
    for a, b in zip(r0["records"], r1["records"]):  # the global values on both ranks
        assert all(a[k] == b[k] for k in LOSS_KEYS), (a, b)
    assert os.listdir(prof) == ["trace_rank0.json"]
    with open(os.path.join(prof, "trace_rank0.json")) as f:
        assert "teacher_tta" in f.read()  # the step's record_function spans

    one = _cfg(tmp_path, batch_size=2)
    state = create_train_state(one, "cpu")
    ckpt.restore_state(os.path.join(str(tmp_path), "run", "ckpt"), state)
    assert state.step == 2
    val = build_val_dataset(one)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' thread count: the same sums in the same order
    try:
        refs = {who: evaluate(one, model, val, threshold_filters=one.eval_threshold_filters,
                              max_images=EVAL_N, device="cpu")
                for who, model in (("student", state.student), ("teacher", state.teacher))}
    finally:
        torch.set_num_threads(threads)
    for who, ref in refs.items():
        for out in (r0, r1):
            got = out["results"][who]
            for k in ref:
                if k != "time":
                    np.testing.assert_equal(got[k], ref[k], err_msg=f"{who} {k}")
    with open(os.path.join(str(tmp_path), "run", "log_val.txt")) as f:
        assert f.read().count("iters:1") == 1  # rank 0 alone writes the logs


def _close(a: torch.Tensor, b: torch.Tensor, rel: float, floor: float = 0.0) -> bool:
    return float((a - b).abs().max()) <= rel * max(float(b.abs().max()), floor)


def _same_state(ours, ref):
    """A checkpoint's weights within 1e-5 (floor 1e-3) and its AdamW moments
    within 1e-4 of ``ref``'s, every tensor at its full shape."""
    for name in ("student", "teacher"):
        assert set(ours[name]) == set(ref[name])
        for k, v in ref[name].items():
            assert ours[name][k].shape == v.shape and _close(ours[name][k], v, 1e-5, 1e-3), (name, k)
    opt, ref_opt = ours["optimizer"]["state"], ref["optimizer"]["state"]
    assert set(opt) == set(ref_opt)
    for i, st in ref_opt.items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert opt[i][k].shape == st[k].shape and _close(opt[i][k], st[k], 1e-4), (i, k)


def test_tp2_checkpoint_resumes_in_one_process(tmp_path):
    cfg = _cfg(tmp_path, batch_size=2, tp=2, max_iters=4, checkpoint_keep=2, lr=1e-9,
               fasteval_n=2)
    straight = spawn(train_worker, 2, [cfg], "cpu")[0][0]
    ck_dir = os.path.join(str(tmp_path), "run", "ckpt")
    assert ckpt.latest_step(ck_dir) == 4
    load = lambda d, step: torch.load(os.path.join(d, f"step_{step:08d}.pt"),  # noqa: E731
                                      weights_only=True)
    train(_cfg(tmp_path, batch_size=2, lr=1e-9, fasteval_n=2, name="one"), device="cpu")
    _same_state(load(ck_dir, 2), load(os.path.join(str(tmp_path), "one", "ckpt"), 2))

    one = _cfg(tmp_path, batch_size=2, max_iters=4, lr=1e-9, fasteval_n=2, name="resumed",
               resume=os.path.join(ck_dir, "step_00000002.pt"))
    res = train(one, device="cpu")
    assert [r["iter"] for r in res["records"]] == [3, 4]
    for a, b in zip(res["records"], straight["records"][2:]):
        for k in LOSS_KEYS:
            assert abs(a[k] - b[k]) <= 1e-4 * max(abs(b[k]), 1e-3), (k, a[k], b[k])

    state = res["state"]
    assert state.step == 4
    _same_state(dict(student=state.student.state_dict(), teacher=state.teacher.state_dict(),
                     optimizer=state.optimizer.opt.state_dict()), load(ck_dir, 4))
