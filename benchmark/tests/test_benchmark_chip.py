"""One short run of each cell on the card; skips where there is none.

    python -m pytest --noconftest -m cuda benchmark/tests/test_benchmark_chip.py
"""

import json

import pytest
import torch

from benchmark import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_short_run_is_correct(card, cell):
    from benchmark.run import run_cell

    harness.set_environment(harness.ROOT)
    line = run_cell(cell, 2 ** 31 + 7, 3.0, False)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert all(v["value"] > 0 for v in line["metrics"].values())
