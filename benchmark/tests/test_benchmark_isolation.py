"""What the benchmark loads: never JAX or the JAX package, and the plain
reference nothing of the program."""

import subprocess
import sys
import types
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_check_names_jax_and_the_jax_package_by_whole_top_level_names(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "cosa_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib_fake.sub", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cosa_tpu.fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["cosa_tpu", "jax"]


def test_the_reference_imports_nothing_of_the_program_or_jax():
    mods = _modules_after("import benchmark.reference.cosa, benchmark.reference.model, "
                          "benchmark.reference.ops, benchmark.counts, benchmark.check, "
                          "benchmark.frozen.synthwsss, benchmark.frozen.trace")
    assert not {"cosa_tpu_torch", "cosa_tpu", "jax", "jaxlib", "flax"} & set(mods)


def test_a_cpu_rehearsal_loads_no_jax():
    code = ("from benchmark.run import run_cell\n"
            "from benchmark.tests.tiny import TRAIN\n"
            "run_cell('voc.train_staged', 5, 0.2, False, 'cpu', TRAIN)")
    mods = set(_modules_after(code))
    assert "cosa_tpu_torch" in mods
    assert not {"cosa_tpu", "jax", "jaxlib", "flax"} & mods


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "voc.train_staged",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
