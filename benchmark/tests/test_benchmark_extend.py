"""A later change adds a cell, a configuration, a traffic mix and generator,
an end-to-end metric and a per-layer metric as new files and new entries,
and edits no file the benchmark has: shown on a scratch copy, where the
new cell runs."""

import hashlib
import json
import shutil
from pathlib import Path

from benchmark import harness
from benchmark.run import run_cell

ROOT = Path(__file__).resolve().parents[2]

GENERATOR = '''
class Dummy:
    spans = ("bench.call",)
    trace_units = 1

    def __init__(self, ctx):
        self.size = ctx.traffic["images_per_call"]

    def call(self):
        return self.size

    trace_call = call

    def attempted(self, window):
        return window["calls"]

    def check(self):
        return {"gap": 0.0}


def build(ctx):
    return Dummy(ctx)
'''

METRIC = '''
SOURCE = "host_clock"
LAYER = "dummy layer"


def read(r):
    return r.window["images"] / r.window["seconds"] / 2
'''

E2E_METRIC = '''
SOURCE = "host_clock"


def read(r):
    return r.window["images"] / r.window["seconds"]
'''


def _digests(root: Path):
    files = [root / "BENCHMARK.json"] + sorted((root / "benchmark").rglob("*"))
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in files if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_make_a_new_cell(tmp_path):
    root = tmp_path / "checkout"
    (root).mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy_cfg", "source": "https://example.org/dummy",
                            "file": "benchmark/configs/dummy_cfg.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg", "traffic": "dummy_mix",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "dummy_img_per_s", "unit": "img/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": ["dummy.cell"]})
    spec["per_layer"].append({"name": "dummy_rate.half", "unit": "img/s", "better": "higher",
                              "source": "host_clock", "layer": "dummy layer",
                              "moves": "dummy_img_per_s"})
    new = {"BENCHMARK.json": json.dumps(spec),
           "benchmark/configs/dummy_cfg.json": json.dumps({"name": "dummy_cfg"}),
           "benchmark/traffic/dummy_mix.json": json.dumps({"generator": "dummy",
                                                           "images_per_call": 3}),
           "benchmark/traffic/dummy.py": GENERATOR,
           "benchmark/metrics/dummy_rate.half.py": METRIC,
           "benchmark/metrics/dummy_img_per_s.py": E2E_METRIC,
           "benchmark/workloads/dummy.cell.json": json.dumps({"limits": {"gap": 0.1},
                                                              "readings": {"gap": [0.0]}})}
    for rel, text in new.items():
        (root / rel).write_text(text)
    after = _digests(root)
    changed = {k for k in before if before[k] != after[k]}
    assert changed == {"BENCHMARK.json"}  # entries added to it, no other file touched

    cell = harness.find_cell("dummy.cell", root)
    assert [m["name"] for m in cell.per_layer] == ["dummy_rate.half"]
    assert {m["name"] for m in cell.end_to_end} >= {"dummy_img_per_s", "setup_s"}
    wl = cell.generator.build(type("Ctx", (), {"traffic": cell.traffic})())
    window = {"calls": 4, "images": 4 * wl.call(), "seconds": 2.0, "call_s": [0.5] * 4}
    reading = harness.Reading(cell.config, cell.traffic, window, {"units": 1}, 7.0, 2 ** 30)
    assert harness.read_metrics(cell, cell.per_layer, reading) == {
        "dummy_rate.half": {"value": 3.0, "unit": "img/s"}}
    assert {k: v["value"] for k, v in harness.read_metrics(cell, cell.end_to_end,
                                                           reading).items()} == {
        "dummy_img_per_s": 6.0, "peak_mem_gib": 1.0, "setup_s": 7.0}
    assert harness.judge(wl.check(), cell.limits)
    for trace in (False, True):  # the harness runs the new cell, every reader found
        line = run_cell("dummy.cell", 5, 0.2, trace, "cpu", root=root)
        assert line["correct"] is True and line["attempted"] > 0
    # the cells that were there still read their own files
    old = harness.find_cell("voc.train_staged", root)
    assert "dummy_rate.half" not in [m["name"] for m in old.per_layer]
