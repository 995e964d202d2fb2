"""The attention audit (cosa_tpu_torch/cli/audit_attention.py) and the
two-arm rank-sum rule of cli/report_parity.py, on the CPU.

The float64 attention (kernels/flash.py::f64_attention_qkv) against the
port's plain attention in f32 (relative 2e-6 in norm) and against the JAX
package's ``_xla_attention`` in f32 (relative 1e-5 in norm), on the same
seeded numpy inputs; the audit end to end on the state a 2-step
``vit_tiny_test`` run of the ``gmmab_fixed`` preset leaves (every column
present; on the CPU the kernels' wrapper takes the plain version, so the
kernel and plain columns are equal); its rule on hand-made reports; the
rank-sum verdicts on hand-made logs: 3 runs completely above 4 give
``fault`` at p = 1/35, one swap gives ``spread`` at p = 2/35.
"""

import json
import os

import numpy as np
import pytest
import torch

from cosa_tpu_torch.cli import audit_attention, make_synth_data, report_parity, run_synth
from cosa_tpu_torch.kernels import flash


def _qkv(b, n, h, seed=0):
    return np.random.default_rng(seed).standard_normal((b, n, 3 * h * 64)).astype(np.float32)


@pytest.mark.parametrize("n_valid", [None, 30])
def test_f64_attention_matches_plain_f32_and_jax(n_valid):
    import jax.numpy as jnp

    from cosa_tpu.kernels.attention import _xla_attention

    b, n, h, scale = 2, 37, 3, 0.125
    x = _qkv(b, n, h)
    ref = flash.f64_attention_qkv(torch.from_numpy(x), h, scale, n_valid)
    assert ref.dtype == torch.float64 and ref.shape == (b, n, h * 64)
    plain = flash.plain_attention_qkv(torch.from_numpy(x), h, scale, n_valid)
    assert audit_attention.rel_err(plain, ref) < 2e-6
    q, k, v = (jnp.asarray(x.reshape(b, n, 3, h, 64)[:, :, i]) for i in range(3))
    ours = np.array(_xla_attention(q, k, v, scale, n_valid)).reshape(b, n, h * 64)
    assert audit_attention.rel_err(torch.from_numpy(ours), ref) < 1e-5


def test_f64_attention_gradient_matches_plain_f32():
    b, n, h, scale = 2, 21, 2, 0.125
    x = torch.from_numpy(_qkv(b, n, h, seed=1))
    dout = torch.from_numpy(np.random.default_rng(2).standard_normal((b, n, h * 64)))
    grads = []
    for fn, dt in ((flash.f64_attention_qkv, torch.float64),
                   (flash.plain_attention_qkv, torch.float32)):
        xi = x.to(dt).requires_grad_(True)
        (g,) = torch.autograd.grad(fn(xi, h, scale), xi, dout.to(dt))
        grads.append(g)
    assert grads[0].dtype == torch.float64
    assert audit_attention.rel_err(grads[1], grads[0]) < 1e-5


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A 2-step vit_tiny_test run of the gmmab_fixed preset and its flags."""
    tmp = tmp_path_factory.mktemp("audit")
    root, work = str(tmp / "data"), str(tmp / "work")
    make_synth_data.main(["--root", root, "--n_train", "4", "--n_val", "2", "--seed", "0"])
    flags = ["--data_root", root, "--split_dir", os.path.join(root, "splits"),
             "--backbone", "vit_tiny_test", "--crop_size", "64", "--work_dir", work,
             "--device", "cpu"]
    run_synth.main(["gmmab_fixed", "tiny", *flags, "--max_iters", "2", "--eval_iters", "2",
                    "--log_iters", "1", "--finalval", "false"])
    return str(tmp), flags, os.path.join(work, "tiny")


def test_audit_end_to_end_cpu(tiny_run, capsys):
    tmp, flags, run_dir = tiny_run
    out = os.path.join(tmp, "out")
    ckpt = os.path.join(run_dir, "ckpt", "step_00000002.pt")
    rc = audit_attention.main(["gmmab_fixed", "tiny", *flags, "--ckpt", ckpt, "--out", out,
                               "--repeat", "2"])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"step": 2, "verdict": "clean", "faults": []}
    with open(os.path.join(out, "audit_step00002.json")) as f:
        rep = json.load(f)
    assert os.path.exists(os.path.join(out, "audit_step00002.txt"))
    # vit_tiny_test: 3 blocks, each at the 3 TTA scales and in the student
    names = [s["site"] for s in rep["sites"]]
    assert len(names) == 12 and len(set(names)) == 12
    assert sum(s["role"] == "student" for s in rep["sites"]) == 3
    for s in rep["sites"]:
        want = {"out", "dq", "dk", "dv"} if s["role"] == "student" else {"out"}
        assert set(s["err"]) == want
        for key, e in s["err"].items():
            # the kernels' wrapper takes the plain version on the CPU
            assert e["kernel"] == e["plain"] and 0 < e["plain"] < 0.05, (s["site"], key)
            if key != "out":
                assert e["cos_kernel"] == e["cos_plain"] > 0.999
        stats = {"pmax_median", "logit_min", "logit_max", "logit_std"}
        if s["role"] == "student":
            stats |= {"dq_q01", "dq_q50", "dq_zero_share", "share_under_2m36", "grid_err"}
            assert s["grid_err"] < 1e-6
            assert set(s["k2_emulation"]) == set(audit_attention.K2_VARIANTS)
            assert all(0 < e < 0.05 for e in s["k2_emulation"].values())
        assert stats <= set(s)
        assert 0 < s["pmax_median"] <= 1 and s["logit_min"] < s["logit_max"]
    t = rep["teacher"]
    assert t["flips"]["kernel"] == t["flips"]["plain"]
    assert t["kernel"] == t["plain"] and t["pixels"] == 4 * 64 * 64
    r = rep["repeat"]
    assert (r["calls"], r["k1_per_call"], r["k2_per_call"]) == (2, 4, 1)
    assert r["k1_mismatch"] == r["k2_mismatch"] == 0
    assert set(rep["losses"]) == {"overall_loss", "cls_loss", "cls_aux_loss", "seg_loss",
                                  "cam_loss", "reg_loss"}


def test_watch_copies_each_checkpoint_in_order(tmp_path):
    run_dir = tmp_path / "run"
    (run_dir / "ckpt").mkdir(parents=True)
    for step in (2, 4):
        (run_dir / "ckpt" / f"step_{step:08d}.pt").write_bytes(bytes([step]))
    got = list(audit_attention.watch(str(run_dir), [2, 4], poll=0.01))
    pid = os.getpid()
    assert [os.path.basename(p) for p in got] == [f"audit_00000002.{pid}.pt",
                                                  f"audit_00000004.{pid}.pt"]
    assert [open(p, "rb").read() for p in got] == [b"\x02", b"\x04"]


def _report(kernel, plain, flips=(10, 10), mismatch=0):
    return dict(step=7, sites=[dict(site="student.b0@785", err=dict(
        out=dict(kernel=1e-3, plain=1e-3), dq=dict(kernel=kernel, plain=plain)))],
        teacher=dict(flips=dict(kernel=flips[0], plain=flips[1])),
        repeat=dict(k1_mismatch=0, k2_mismatch=mismatch))


@pytest.mark.parametrize("rep,verdict", [
    (_report(2 * 1e-2 + 1e-3, 1e-2), "clean"),  # at the bound
    (_report(2 * 1e-2 + 2e-3, 1e-2), "fault"),  # over it
    (_report(1e-3, 1e-2, flips=(16, 10)), "fault"),  # flips over 1.5x
    (_report(1e-3, 1e-2, flips=(15, 10)), "clean"),
    (_report(1e-3, 1e-2, mismatch=1), "fault"),  # a repeat differs
])
def test_audit_rule(rep, verdict):
    assert audit_attention.verdict(rep)["verdict"] == verdict


def _run_dir(tmp_path, name, best):
    d = tmp_path / name
    d.mkdir()
    recs = [dict(kind="val", model="ON", iter=500, Seg_vd=best / 200),
            dict(kind="val", model="AN", iter=500, Seg_vd=best / 100)]
    (d / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(d)


@pytest.mark.parametrize("a,b,p,verdict", [
    ((60, 61, 62), (40, 41, 42, 43), 1 / 35, "fault"),  # complete separation
    ((60, 61, 42.5), (40, 41, 42, 43), 2 / 35, "spread"),  # one swap
])
def test_report_parity_arms_rank_sum(tmp_path, capsys, a, b, p, verdict):
    jax = _run_dir(tmp_path, "jax", 60.0)
    arm_a = [_run_dir(tmp_path, f"a{i}", v) for i, v in enumerate(a)]
    arm_b = [_run_dir(tmp_path, f"b{i}", v) for i, v in enumerate(b)]
    res = report_parity.main(["--jax", jax, "--arms", *arm_a, "--", *arm_b])
    assert res["verdict"] == verdict
    assert res["rank_sum"]["p"] == pytest.approx(p) and res["rank_sum"]["splits"] == 35
    assert res["need"] == pytest.approx(51.0)
    assert res["meets"] == {**{f"a{i}": v >= 51 for i, v in enumerate(a)},
                            **{f"b{i}": False for i in range(4)}}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["verdict"] == verdict
