"""The readers of the program's validation and TTA spans
(``benchmark/metrics/*_idle_ms.*.py``) on hand-written reductions: each sums
the idle gaps of its spans and divides by the steps or the batches
profiled; a span outside the reduction's list reads 0, and a trace with no
device events, or of a program without these spans, reads nothing."""

import json
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.frozen.trace import reduce_trace

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIG = {"config": {"eval_batch": 8}}
TRAFFIC = {"trace_images": 32}
# metric -> (its spans, its cells)
EVAL = ["voc.val_tta"]
TRAIN = ["voc.train_staged", "coco.train_staged"]
READERS = {
    "load_idle_ms.eval": (("eval_load",), EVAL),
    "tta_idle_ms.eval": (("tta_forward", "tta_fuse"), EVAL),
    "canvas_idle_ms.eval": (("eval_prep", "eval_canvas"), EVAL),
    "score_idle_ms.eval": (("eval_score", "eval_ap"), EVAL),
    "tta_forward_idle_ms.train": (("tta_forward",), TRAIN),
    "tta_fuse_idle_ms.train": (("tta_fuse",), TRAIN),
}
GAPS = {"eval_load": 0.32, "tta_forward": 0.04, "tta_fuse": 0.02, "eval_prep": 0.016,
        "eval_canvas": 0.008, "eval_score": 0.024, "eval_ap": 0.004, "bench.call": 0.001}


def _read(name, trace):
    mod = harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")
    return mod.read(harness.Reading(CONFIG, TRAFFIC, {}, trace))


def _base(name, units):
    return units if name.endswith(".train") else units * TRAFFIC["trace_images"] / 8


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_sums_its_gaps_over_its_base(name):
    spans, cells = READERS[name]
    trace = dict(units=2, busy_s=1.0, idle_gaps=[[k, v] for k, v in GAPS.items()])
    want = sum(GAPS[k] for k in spans) * 1e3 / _base(name, 2)
    assert _read(name, trace) == pytest.approx(want)
    entry, = [m for m in SPEC["per_layer"] if m["name"] == name]
    assert entry == dict(name=name, unit="ms", better="lower", source="program_span",
                         layer="eval engine" if name.endswith(".eval") else "train step",
                         moves="eval_img_per_s" if name.endswith(".eval")
                         else "train_img_per_s", workloads=cells)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_span_missing_from_the_list_reads_zero(name):
    spans, _ = READERS[name]
    other = next(k for k in ("tta_fuse", "tta_forward", "eval_load") if k not in spans)
    trace = dict(units=6, busy_s=1.0, idle_gaps=[["backward", 0.2], [other, 0.1]])
    assert _read(name, trace) == 0.0


@pytest.mark.parametrize("name", sorted(READERS))
def test_no_device_events_or_no_program_span_reads_nothing(name):
    assert _read(name, dict(units=2, steps=2)) is None  # reduce_trace found no device event
    parent = dict(units=2, busy_s=1.0, idle_gaps=[["bench.call", 0.596], ["teacher_tta", 0.1]])
    assert _read(name, parent) is None


def _x(name, ts, dur, cat="user_annotation", **args):
    return dict(ph="X", name=name, ts=ts, dur=dur, cat=cat, args=args)


def test_the_innermost_span_names_the_gap_through_the_frozen_reduction():
    """A profiled step whose TTA holds a forward and a fuse: a gap whose
    middle lies inside ``tta_forward`` (and so inside ``teacher_tta``) is
    that span's, and ``teacher_tta`` keeps the device time of what is
    launched inside it."""
    events = [
        _x("ProfilerStep#1", 0, 1000),
        _x("bench.call", 0, 1000),
        _x("teacher_tta", 10, 890),
        _x("tta_forward", 100, 400),
        _x("tta_fuse", 500, 400),
        _x("cudaLaunchKernel", 110, 5, cat="cuda_runtime", correlation=1),
        _x("cudaLaunchKernel", 510, 5, cat="cuda_runtime", correlation=2),
        _x("k1", 120, 80, cat="kernel", correlation=1),
        _x("k2", 520, 80, cat="kernel", correlation=2),
        _x("k3", 800, 200, cat="kernel"),
    ]
    red = reduce_trace({"traceEvents": events}, ("bench.call", "teacher_tta"))
    red["units"] = 1
    assert dict(red["idle_gaps"]) == pytest.approx(
        {"teacher_tta": 120e-6, "tta_forward": 320e-6, "tta_fuse": 200e-6})
    assert red["device_s"]["teacher_tta"] == pytest.approx(160e-6)
    assert _read("tta_forward_idle_ms.train", red) == pytest.approx(0.32)
    assert _read("tta_fuse_idle_ms.train", red) == pytest.approx(0.2)
