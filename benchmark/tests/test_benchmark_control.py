"""The correctness check's witnesses at a size a test run can hold: the
plain reference equals the program computed in float32; the control (the
reference with float8 operands, benchmark/control.py) and the planted
faults (the losses over half of the batch, the update taken the wrong way)
read above the program's bfloat16 runs."""

import json

import pytest

from benchmark import harness
from benchmark.control import readings
from benchmark.run import run_cell
from benchmark.tests.tiny import OVERRIDES


def _f32(cell):
    over = json.loads(json.dumps(OVERRIDES[cell]))
    over["config"]["config"]["mixed_precision"] = False
    return over


def test_the_reference_is_the_program_in_float32_for_the_step():
    over = _f32("voc.train_staged")
    numbers = run_cell("voc.train_staged", 77, 0.2, False, "cpu", over)["numbers"]
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-5 and numbers["update_gap"] < 1e-5 and numbers["ema_gap"] < 1e-5
    assert numbers["logit_err"] < 1e-5 and numbers["tta_err"] < 1e-5 and numbers["seg_err"] < 1e-5
    assert numbers["soft_err"] < 1e-5
    assert numbers["mask_flip"] == 0.0 and numbers["update_sign"] == 0.0


def test_the_reference_is_the_program_in_float32_for_validation():
    numbers = run_cell("voc.val_tta", 78, 0.2, False, "cpu", _f32("voc.val_tta"))["numbers"]
    assert numbers == {"hist_gap": 0.0, "seg_gap": 0.0}


@pytest.mark.parametrize("cell", ["voc.train_staged", "voc.val_tta"])
def test_the_control_reads_above_the_program_and_is_not_correct(cell):
    rows = readings(cell, [5, 6], True, True, "cpu", OVERRIDES[cell])
    by = {(r["seed"], r["reading"]): r for r in rows}
    limits = harness.find_cell(cell).limits
    key = "logit_err" if cell.endswith("staged") else "hist_gap"
    for seed in (5, 6):
        assert harness.judge(by[seed, "program"], limits)
        assert not harness.judge(by[seed, "control"], limits)
        assert by[seed, "control"][key] > 2 * by[seed, "program"][key]
        if cell.endswith("staged"):
            for fault in ("half_loss", "flipped_update"):
                assert not harness.judge(by[seed, fault], limits)
