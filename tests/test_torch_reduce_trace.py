"""The benchmark's trace reader (``benchmark/frozen/trace.py::reduce_trace``),
behind every per-layer metric and the traced run's ``breakdown``, held to
hand-written chrome traces with exact answers under its own rules: a
device event goes to the innermost listed span that holds its launch on the
host (by the launch's ``correlation`` id), a moment that several owners'
events cover goes to the span listed first, and each idle gap of the device
is named by the innermost host annotation open at its middle."""

import pytest

from benchmark.frozen.trace import reduce_trace

# the train generators' span list (benchmark/traffic/train.py::SPANS)
SPANS = ("bench.call", "teacher_tta", "gmm", "pseudo_labels", "student_forward", "losses",
         "energy", "backward", "optimizer", "ema")


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_trace_on_a_hand_written_trace():
    """One step (host 1000-2000 us). teacher_tta launches a K1 kernel, a
    product, a copy and a memset on another stream that overlaps the K1
    kernel (400 us busy); the optimizer launches an elementwise kernel from
    an unlisted span nested in its own (100 us); a K3 kernel is launched
    outside every span and one kernel has no launch record (60 us
    unattributed); the rest of the window is idle, 100 us of it under
    teacher_tta, 100 us under the unlisted optimizer span, 240 us under no
    span; a kernel before the step is left out."""
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
    red = reduce_trace({"traceEvents": ev}, SPANS)
    approx = lambda x: pytest.approx(x, abs=1e-15)  # noqa: E731
    assert red["steps"] == 1
    assert red["window_s"] == approx(1e-3) and red["busy_s"] == approx(5.6e-4)
    assert red["device_s"] == {s: approx({"teacher_tta": 4e-4, "optimizer": 1e-4}.get(s, 0.0))
                               for s in SPANS}
    assert red["unattributed_s"] == approx(6e-5)
    assert sum(red["device_s"].values()) + red["unattributed_s"] == approx(red["busy_s"])
    kernels = [("void attn_fwd_kernel<64, 0>(bf16 const*)", 2e-4), ("sm90_gemm_bf16", 1.5e-4),
               ("elementwise_kernel", 1e-4), ("void rff_phi_kernel<bf16>(float const*)", 5e-5),
               ("no_launch_record", 1e-5)]
    # copies and memsets are busy time but no kernel
    assert red["kernel_s"] == {k: approx(v) for k, v in kernels}
    assert red["device_ops"] == [[k, approx(v)] for k, v in kernels]
    idle = [["host idle", 2.4e-4], ["teacher_tta", 1e-4], ["Optimizer.step#AdamW.step", 1e-4]]
    assert red["idle_gaps"] == [[k, approx(v)] for k, v in idle]
    assert sum(v for _, v in red["idle_gaps"]) + red["busy_s"] == approx(red["window_s"])
    top2 = reduce_trace({"traceEvents": ev}, SPANS, top=2)
    assert top2["device_ops"] == red["device_ops"][:2]
    assert top2["idle_gaps"] == red["idle_gaps"][:2]
    # no device event: the steps only (one, where no step is marked)
    assert reduce_trace({"traceEvents": []}, SPANS) == {"steps": 1}
    assert reduce_trace({"traceEvents": ev[:2]}, SPANS) == {"steps": 1}


def test_overlapping_spans_go_to_the_span_listed_first():
    ev = [_x("user_annotation", "ema", 0, 10), _x("user_annotation", "losses", 20, 10),
          _x("cuda_runtime", "cudaLaunchKernel", 5, 1, 1),
          _x("cuda_runtime", "cudaLaunchKernel", 25, 1, 2),
          _x("kernel", "a", 100, 30, 1), _x("kernel", "b", 110, 40, 2)]
    red = reduce_trace({"traceEvents": ev}, SPANS)
    # losses (listed before ema) owns 110-150, ema the rest of its kernel
    assert red["device_s"]["losses"] == pytest.approx(4e-5)
    assert red["device_s"]["ema"] == pytest.approx(1e-5)
    assert red["busy_s"] == pytest.approx(5e-5) and red["window_s"] == pytest.approx(5e-5)
    assert red["idle_gaps"] == []
    # listed the other way round, ema owns the overlap
    red = reduce_trace({"traceEvents": ev}, ("ema", "losses"))
    assert red["device_s"] == {"ema": pytest.approx(3e-5), "losses": pytest.approx(2e-5)}
