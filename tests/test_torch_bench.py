"""The benchmark and profiling twins (cosa_tpu_torch/cli/bench*.py,
profile_step.py, postrun_queue.py) on the CPU at the tiny width.

Each twin's main runs at 1-2 steps with ``--device cpu``: its JSON lines,
their keys, and no device metric on a CPU line (the card's numbers come
from chip_smoke.py phase 16 and the queue on the card). reduce_trace is held
to a hand-written chrome trace with exact answers; the FLOP counter is
shown to see the plain attention in a whole step, exactly; the queue exits
nonzero when a step fails."""

import json
import sys

import numpy as np
import pytest
import torch

from cosa_tpu_torch.cli import (
    bench,
    bench_e2e,
    bench_lattice,
    bench_loader,
    bench_scales,
    postrun_queue,
    profile_step,
)
from cosa_tpu_torch.config import voc_config
from cosa_tpu_torch.kernels import flash, rff
from cosa_tpu_torch.models import vit
from cosa_tpu_torch.ops import bilateral
from cosa_tpu_torch.train.state import create_train_state
from cosa_tpu_torch.train.step import build_train_step

TINY = ["--device", "cpu", "--backbone", "vit_tiny_test", "--crop_size", "64"]
# metrics only a run on the card may carry
DEVICE_METRICS = ("mfu", "achieved_tflops_per_sec", "device_ms", "idle_share")
STEP_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline", "sec_per_iter",
             "global_batch", "n_devices", "backend", "device", "power_limit", "warmup_s",
             "launches_per_step", "tflops_per_step"}


@pytest.fixture(autouse=True)
def _light(monkeypatch):
    """One torch thread and one warm-up step per timed window: the twins'
    control flow at the least CPU, beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (bench, bench_e2e, bench_loader, profile_step):
        monkeypatch.setattr(mod, "WARMUP", 1)
    yield
    torch.set_num_threads(threads)


def _printed(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def _cpu_line(line):
    assert line["device"] == "cpu"
    assert not set(DEVICE_METRICS) & set(line), line
    for v in line.values():
        if isinstance(v, float):
            assert np.isfinite(v), line


def test_bench_lines_and_the_voc_headline_last(capsys):
    lines = bench.main(TINY + ["--iters", "1", "--repeats", "2"])
    assert _printed(capsys) == lines
    assert [ln["metric"] for ln in lines] == [
        "voc_train_imgs_per_sec", "voc_train_imgs_per_sec", "voc_lattice_train_imgs_per_sec",
        "coco_train_imgs_per_sec", "voc_train_imgs_per_sec"]
    for ln in lines:
        _cpu_line(ln)
        assert STEP_KEYS <= set(ln)
        assert ln["backend"] == "cpu" and ln["n_devices"] == 1 and ln["power_limit"] is None
        # the wrappers count card launches only: the CPU runs the plain versions
        assert ln["launches_per_step"] == {"flash_fwd": 0, "flash_bwd": 0, "rff_phi": 0}
        assert ln["tflops_per_step"] > 0
        assert ln["value"] == pytest.approx(ln["global_batch"] / ln["sec_per_iter"])
    assert [ln["global_batch"] for ln in lines] == [4, 4, 4, 8, 4]
    assert [ln.get("repeat") for ln in lines[:2]] == [0, 1]
    head = lines[-1]
    secs = [ln["sec_per_iter"] for ln in lines[:2]]
    assert head["sec_per_iter_repeats"] == secs and head["repeats"] == 2
    assert head["sec_per_iter"] == pytest.approx(np.median(secs))
    q1, q2, q3 = head["sec_per_iter_quartiles"]
    assert min(secs) <= q1 <= q2 <= q3 <= max(secs)
    assert lines[0]["vs_baseline"] == pytest.approx(lines[0]["value"] / 4.35)


def test_bench_skips_optional_lines_past_the_budget(capsys):
    lines = bench.main(TINY + ["--iters", "1", "--budget_s", "0"])
    assert [(ln["metric"], ln.get("skipped")) for ln in lines] == [
        ("voc_train_imgs_per_sec", None), ("voc_lattice_train_imgs_per_sec", True),
        ("coco_train_imgs_per_sec", True), ("voc_train_imgs_per_sec", None)]
    assert "budget" in lines[1]["reason"] and lines[1]["device"] == "cpu"
    assert "sec_per_iter_quartiles" not in lines[-1]


def test_bench_scales_and_lattice_lines(capsys):
    scales = bench_scales.main(TINY + ["--iters", "1"])
    lattice = bench_lattice.main(TINY + ["--iters", "1"])
    assert _printed(capsys) == scales + lattice
    assert [ln["metric"] for ln in scales] == [
        "voc_train_step_scales_1.0x0.5x1.5", "voc_train_step_scales_1.0x0.5",
        "voc_train_step_scales_1.0"]
    assert [tuple(ln["pseudo_scales"]) for ln in scales] == list(bench_scales.SCALES)
    assert [ln["metric"] for ln in lattice] == ["voc_train_step_energy_rff",
                                                "voc_train_step_energy_lattice"]
    for ln in scales + lattice:
        _cpu_line(ln)
        assert STEP_KEYS <= set(ln)
    # fewer teacher scales, fewer products
    flops = [ln["tflops_per_step"] for ln in scales]
    assert flops[0] > flops[1] > flops[2] > 0


def test_bench_loader_threads_and_processes(tmp_path, capsys):
    bench_e2e.build_tree(str(tmp_path), "voc", 8)
    lines = bench_loader.main(["--data_root", str(tmp_path), "--workers", "1", "-2",
                               "--n_batches", "2"])
    assert _printed(capsys) == lines
    assert [(ln["workers"], ln["pool"]) for ln in lines] == [(1, "thread"), (-2, "process")]
    for ln in lines:
        _cpu_line(ln)
        assert ln["imgs_per_sec"] == pytest.approx(
            ln["batch_size"] / ln["sec_per_batch"])
        assert ln["host_cores"] >= 1 and ln["n_batches"] == 2


@pytest.mark.parametrize("dataset,batch", [("voc", 4), ("coco", 8)])
def test_bench_e2e_line(dataset, batch, capsys):
    line = bench_e2e.main(["1", "--dataset", dataset, "--n_imgs", "8"] + TINY)
    assert _printed(capsys) == [line]
    _cpu_line(line)
    assert line["metric"] == f"{dataset}_e2e_train_imgs_per_sec"
    assert line["global_batch"] == batch and line["num_workers"] == 8
    assert line["value"] == pytest.approx(batch / line["sec_per_iter"])
    assert line["e2e_over_compute"] == pytest.approx(
        line["sec_per_iter"] / line["compute_sec_per_iter"])


def test_profile_step_pieces_and_host_spans(tmp_path, capsys):
    out = str(tmp_path / "trace.json.gz")
    lines = profile_step.main(["--device", "cpu", "--backbone", "vit_tiny_test", "--crop",
                               "64", "--iters", "1", "--steps", "1",
                               "--out", out])
    assert _printed(capsys) == lines
    pieces, prof = lines[:-1], lines[-1]
    assert [ln["piece"] for ln in pieces] == ["full", "teacher_tta", "student_grad", "update"]
    for ln in lines:
        _cpu_line(ln)
    assert all(ln["ms"] > 0 for ln in pieces)
    assert pieces[0]["tflops"] > pieces[1]["tflops"] > 0 and pieces[3]["tflops"] == 0
    assert pieces[0]["tflops"] == pytest.approx(pieces[1]["tflops"] + pieces[2]["tflops"])
    assert prof["profile"] == "full_step" and prof["steps"] == 1 and prof["trace"] == out
    spans = profile_step.default_spans(voc_config())
    assert all(prof["host_ms"][s] > 0 for s in spans) and prof["host_ms"]["gmm"] == 0
    assert "window_ms" not in prof
    trace = profile_step.load_trace(out)
    assert profile_step.reduce_trace(trace) == {k: prof[k] for k in ("steps", "host_ms")}


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_trace_on_a_hand_written_trace():
    """One step (host 1000-2000 us). teacher_tta launches a K1 kernel, a
    product, a copy and a memset on another stream that overlaps the K1
    kernel (400 us busy); the optimizer launches an elementwise kernel from
    a span nested in its own (100 us); a K3 kernel is launched outside every
    span and one kernel has no launch record (60 us unattributed); the rest
    of the window is idle; a kernel before the step is left out."""
    rt = lambda corr, ts: _x("cuda_runtime", "cudaLaunchKernel", ts, 5, corr)  # noqa: E731
    ev = [
        _x("user_annotation", "ProfilerStep#2", 1000, 1000),
        _x("user_annotation", "teacher_tta", 1010, 300),
        rt(1, 1020), rt(2, 1100), rt(3, 1200), rt(4, 1250),
        _x("user_annotation", "optimizer", 1500, 100),
        _x("user_annotation", "Optimizer.step#AdamW.step", 1510, 80),
        rt(5, 1520), rt(6, 1700), rt(7, 490),
        _x("gpu_user_annotation", "Optimizer.step#AdamW.step", 1600, 100),
        _x("kernel", "void attn_fwd_kernel<64, 0>(bf16 const*)", 1100, 200, 1),
        _x("kernel", "sm90_gemm_bf16", 1300, 150, 2),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1450, 50, 3),
        _x("gpu_memset", "Memset (Device)", 1120, 20, 4),
        _x("kernel", "elementwise_kernel", 1600, 100, 5),
        _x("kernel", "void rff_phi_kernel<bf16>(float const*)", 1800, 50, 6),
        _x("kernel", "no_launch_record", 1900, 10),
        _x("kernel", "before_the_window", 500, 100, 7),
        {"ph": "M", "name": "process_name", "pid": 0},
    ]
    red = profile_step.reduce_trace({"traceEvents": ev})
    approx = lambda x: pytest.approx(x, abs=1e-12)  # noqa: E731
    assert red["steps"] == 1
    assert red["window_ms"] == approx(1.0) and red["busy_ms"] == approx(0.56)
    assert red["idle_ms"] == approx(0.44) and red["idle_share"] == approx(0.44)
    assert red["busy_share"] == approx(0.56)
    assert red["device_ms"] == {s: approx({"teacher_tta": 0.4, "optimizer": 0.1}.get(s, 0.0))
                                for s in profile_step.SPANS}
    assert red["unattributed_ms"] == approx(0.06)
    total = sum(red["device_ms"].values()) + red["unattributed_ms"] + red["idle_ms"]
    assert total == approx(red["window_ms"])
    assert red["host_ms"] == {s: approx({"teacher_tta": 0.3, "optimizer": 0.1}.get(s, 0.0))
                              for s in profile_step.SPANS}
    assert red["n_kernel_events"] == 5
    assert [(k["name"], k["kernel"], k["ms"], k["calls"]) for k in red["top_kernels"]] == [
        ("void attn_fwd_kernel<64, 0>(bf16 const*)", "K1", approx(0.2), 1),
        ("sm90_gemm_bf16", None, approx(0.15), 1), ("elementwise_kernel", None, approx(0.1), 1),
        ("void rff_phi_kernel<bf16>(float const*)", "K3", approx(0.05), 1),
        ("no_launch_record", None, approx(0.01), 1)]
    assert red["kernel_share"] == {"K1": approx(0.2 / 0.56), "K2": 0.0,
                                   "K3": approx(0.05 / 0.56)}
    # no device events and no steps: the host spans only, of one step
    assert profile_step.reduce_trace({"traceEvents": []}) == dict(
        steps=1, host_ms=dict.fromkeys(profile_step.SPANS, 0.0))


def test_overlapping_spans_go_to_the_span_listed_first():
    ev = [_x("user_annotation", "ema", 0, 10), _x("user_annotation", "losses", 20, 10),
          _x("cuda_runtime", "cudaLaunchKernel", 5, 1, 1),
          _x("cuda_runtime", "cudaLaunchKernel", 25, 1, 2),
          _x("kernel", "a", 100, 30, 1), _x("kernel", "b", 110, 40, 2)]
    red = profile_step.reduce_trace({"traceEvents": ev})
    # losses (listed before ema) owns 110-150, ema the rest of its kernel
    assert red["device_ms"]["losses"] == pytest.approx(0.04)
    assert red["device_ms"]["ema"] == pytest.approx(0.01)
    assert red["busy_ms"] == pytest.approx(0.05) and red["window_ms"] == pytest.approx(0.05)


def test_flop_counter_sees_the_plain_attention(monkeypatch):
    """A whole step's count with the plain attention minus its count with a
    stub (which returns v, no product) is 4 B H N^2 d per forward call and
    8 B H N^2 d more per call the backward goes through, exactly."""
    cfg = voc_config(batch_size=2, energy_convention=1.0, backbone="vit_tiny_test",
                     crop_size=64, mixed_precision=False)
    state = create_train_state(cfg, "cpu", 2)
    step = build_train_step(cfg)
    batch = bench.random_batch(cfg, 2, torch.device("cpu"))
    calls = []
    real = vit.attention

    def recorded(qkv, num_heads, scale, use_kernel, n_valid=None):
        b, n, c3 = qkv.shape
        calls.append((b * num_heads * n * n * (c3 // 3 // num_heads), qkv.requires_grad))
        return real(qkv, num_heads, scale, use_kernel, n_valid)

    def stub(qkv, num_heads, scale, use_kernel, n_valid=None):
        return qkv[..., 2 * qkv.shape[-1] // 3:]

    monkeypatch.setattr(vit, "attention", recorded)
    with bench.plain_kernels(state.student, state.teacher):
        with_attn = bench.count_flops(lambda: step(state, batch))
    monkeypatch.setattr(vit, "attention", stub)
    without = bench.count_flops(lambda: step(state, batch))
    # 3 blocks x (3 teacher scales + 1 student); the student's 3 take the backward
    assert len(calls) == 12 and sum(g for _, g in calls) == 3
    assert with_attn - without == sum(4 * w + (8 * w if g else 0) for w, g in calls)


def test_bmm_flops_take_the_out_dtype_overload():
    a, b = torch.randn(3, 5, 7), torch.randn(3, 7, 11)
    assert bench.bmm_flops(a.shape, b.shape, torch.float32, out_shape=(3, 5, 11)) == 2310
    assert bench.count_flops(lambda: torch.bmm(a, b)) == 2 * 3 * 5 * 7 * 11


def test_plain_kernels_and_rates():
    cfg = voc_config(backbone="vit_tiny_test", crop_size=64)
    state = create_train_state(cfg, "cpu", 1)
    attn = [m for m in state.student.modules() if isinstance(getattr(m, "use_kernel", None), bool)]
    assert attn and all(m.use_kernel for m in attn)
    phi = bilateral.rff_phi
    with bench.plain_kernels(state.student):
        assert not any(m.use_kernel for m in attn)
        assert bilateral.rff_phi is rff.plain_rff_phi
    assert all(m.use_kernel for m in attn) and bilateral.rff_phi is phi is rff.rff_phi
    assert flash.LAUNCHES.keys() | rff.LAUNCHES.keys() == bench.launches().keys()
    assert bench.rates(2e12, 0.5, {"device": "cpu"}) == {"tflops_per_step": 2.0}
    card = bench.rates(2e12, 0.5, {"device": "NVIDIA H100 80GB HBM3"})
    assert card["achieved_tflops_per_sec"] == 4.0 and card["mfu"] == 4.0 / 989.0
    other = bench.rates(2e12, 0.5, {"device": "NVIDIA A100-SXM4-80GB"})
    assert "mfu" not in other and "A100" in other["mfu_reason"]


def test_postrun_queue_exits_nonzero_when_a_step_fails(tmp_path, capsys):
    py = sys.executable
    steps = [postrun_queue.Step("ok", [py, "-c", "print('{\"a\": 1}')"], 60, True),
             postrun_queue.Step("bad", [py, "-c", "import sys; sys.exit(3)"], 60, False),
             postrun_queue.Step("after", [py, "-c", "print('ran')"], 60, False)]
    assert postrun_queue.main(["--out", str(tmp_path)], steps=steps) == 1
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert [(r["step"], r["rc"]) for r in last["postrun"]] == [("ok", 0), ("bad", 3), ("after", 0)]
    assert last["failed"] == ["bad"]
    assert (tmp_path / "ok.json").read_text() == '{"a": 1}\n'
    assert (tmp_path / "after.log").read_text() == "ran\n"
    assert postrun_queue.main(["--out", str(tmp_path)], steps=steps[:1]) == 0


def test_postrun_queue_default_steps(tmp_path):
    steps = postrun_queue.default_steps(str(tmp_path))
    assert [s.name for s in steps] == ["tree", "cuda_tests", "bench_lattice", "bench_scales",
                                       "bench", "bench_loader", "bench_e2e", "profile_step"]
    by = {s.name: s for s in steps}
    assert by["cuda_tests"].argv[1:] == ["-m", "pytest", "--noconftest", "-m", "cuda",
                                         "tests/test_torch_cuda.py", "-q", "-p",
                                         "no:cacheprovider"]
    assert by["bench"].argv[-2:] == ["--repeats", "3"]
    assert by["bench_loader"].argv[-1] == str(tmp_path / "tree")
    assert [s.json_lines for s in steps].count(True) == 6
