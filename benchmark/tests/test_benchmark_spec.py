"""BENCHMARK.json keeps to the benchmark's contract, and every file a name
in it points to is found by that name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expansion",
               "experts_per_tok")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_check_fits_its_time_with_24_cells():
    per_run = SPEC["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or any(w in k for w in WIDTH_WORDS)
                       for k in c["reduced"])
    cells = SPEC["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        assert any(c["name"] == w["config"] for c in SPEC["configs"])
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in cells}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_e2e_metric_and_a_layer_metric():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if harness.applies(m, w["name"], SPEC)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in SPEC["per_layer"] if harness.applies(m, w["name"], SPEC)]
        assert layer and all(harness.applies(e2e_m, w["name"], SPEC)
                             for m in layer for e2e_m in SPEC["end_to_end"]
                             if e2e_m["name"] == m["moves"])


def test_one_layer_name_per_layer():
    for m in SPEC["per_layer"]:
        mod = harness.load_module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py")
        assert mod.SOURCE == m["source"] and mod.LAYER == m["layer"]
        assert callable(mod.read)


def test_every_end_to_end_metric_has_its_reader():
    for m in SPEC["end_to_end"]:
        mod = harness.load_module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py")
        assert mod.SOURCE == m["source"] and callable(mod.read)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_is_found_by_name(cell):
    c = harness.find_cell(cell, ROOT)
    assert c.generator.build and c.limits and c.config["name"] in {x["name"] for x in SPEC["configs"]}
    assert (ROOT / "benchmark" / "traffic" / f"{c.traffic['generator']}.py").is_file()
    readings = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())
    assert set(readings["limits"]) <= set(readings["readings"])


def test_configurations_state_their_source_and_cuts():
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["assumed"] and conf["widths"]["embed_dim"] == 768
        assert conf["widths"]["depth"] == 12 and conf["widths"]["num_heads"] == 12
