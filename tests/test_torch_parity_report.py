"""PyTorch port: cli/report_parity.py on the committed learning runs and on
small written logs (log files only; no model, no jax)."""

import json
import os

import pytest

from cosa_tpu_torch.cli import report_parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "work_dirs")
AT = ["--at", "3000", "3500", "4500"]


def _run(capsys, argv):
    """report_parity's result, its printed lines, and its last line read as
    JSON (which must equal the result)."""
    result = report_parity.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == result
    return result, lines


def _write(path, on, best=None, final=None):
    """A metrics.jsonl with ON Seg_vd ``on`` ({iter: x100}), one AN reading
    of ``best`` at the last iteration, and a final record."""
    os.makedirs(path)
    with open(os.path.join(path, "metrics.jsonl"), "w") as f:
        f.write(json.dumps(dict(kind="train", iter=1, itertime=0.1)) + "\n")
        for it, v in on.items():
            f.write(json.dumps(dict(kind="val", model="ON", iter=it, Seg_vd=v / 100)) + "\n")
        an = best if best is not None else 1.0
        f.write(json.dumps(dict(kind="val", model="AN", iter=max(on), Seg_vd=an / 100)) + "\n")
        fin = final if final is not None else max(max(on.values()), an)
        f.write(json.dumps(dict(kind="final", Seg_vd=fin / 100, Seg_crf=fin / 100 + 0.005))
                + "\n")
    return str(path)


def test_rule_a_on_the_committed_synthrun_seeds(capsys):
    res, lines = _run(capsys, ["--jax", os.path.join(WORK, "synthrun_r3"), "--port",
                               os.path.join(WORK, "torch_synthrun_h100"),
                               os.path.join(WORK, "torch_synthrun_seed1_h100")] + AT)
    a = res["rule_a"]
    assert a["above_at"] == [3000, 3500, 4500] and a["n_above"] == 3 and a["missing"] == []
    assert a["best_above"] and a["faults"] == 2 and a["runs"] == 2
    assert a["seeds_needed"] == 4 and res["verdict"] == a["verdict"] == "undecided"
    # the table: a header, a rule and one row per validation of the 10k runs
    rows = [ln for ln in lines if ln.startswith("| ")]
    assert len(rows) == 1 + 20 and rows[0].count("|") == 8
    assert "| 3000 | 40.1 | 24.3 | 23.8 | 23.8 | 24.0 | 24.3 |" in lines
    assert any(ln.startswith("- synthrun_r3: best Seg_vd 67.40 (4500 ON); finaleval Seg "
                             "67.40, +CRF 67.99") for ln in lines)
    assert any("probability 1/3" in ln for ln in lines)


def test_bar_on_the_committed_synthrun_seeds(capsys):
    res, _ = _run(capsys, ["--jax", os.path.join(WORK, "synthrun_r3"), "--port",
                           os.path.join(WORK, "torch_synthrun_h100"),
                           os.path.join(WORK, "torch_synthrun_seed1_h100")])
    assert res["need"] == pytest.approx(0.85 * 67.39919, abs=1e-3)  # 57.29
    assert res["meets"] == {"torch_synthrun_h100": True, "torch_synthrun_seed1_h100": False}
    assert res["port"]["torch_synthrun_h100"] == pytest.approx(59.90, abs=5e-3)
    assert res["port"]["torch_synthrun_seed1_h100"] == pytest.approx(52.15, abs=5e-3)
    assert res["verdict"] is None and "rule_a" not in res  # rule A needs --at


JAX = {3000: 40.0, 3500: 50.0, 4500: 60.0, 5000: 62.0}
# four port runs each; "spread": the JAX run lies above them all at 3000
# only (one run beats it at 3500 and 4500) and another run beats its best;
# "fault": it lies above them all at 3500 and 4500 and above their bests,
# though one run beats it at 3000
CASES = {
    "spread": ([{3000: 30.0, 3500: 55.0, 4500: 61.0, 5000: 58.0},
                {3000: 20.0, 3500: 30.0, 4500: 40.0, 5000: 65.0},
                {3000: 25.0, 3500: 35.0, 4500: 45.0, 5000: 50.0},
                {3000: 22.0, 3500: 33.0, 4500: 44.0, 5000: 55.0}], 1, False),
    "fault": ([{3000: 45.0, 3500: 49.0, 4500: 59.0, 5000: 61.0},
               {3000: 20.0, 3500: 30.0, 4500: 40.0, 5000: 60.0},
               {3000: 25.0, 3500: 35.0, 4500: 45.0, 5000: 50.0},
               {3000: 22.0, 3500: 33.0, 4500: 44.0, 5000: 55.0}], 2, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_a_verdict_with_four_runs(tmp_path, capsys, case):
    ports, n_above, best_above = CASES[case]
    jax = _write(tmp_path / "jax", JAX)
    dirs = [_write(tmp_path / f"port{i}", on) for i, on in enumerate(ports)]
    res, lines = _run(capsys, ["--jax", jax, "--port", *dirs] + AT)
    a = res["rule_a"]
    assert (a["n_above"], a["best_above"], a["runs"]) == (n_above, best_above, 4)
    assert res["verdict"] == case and a["faults"] == (2 if case == "fault" else 0)
    assert any("probability 1/5" in ln for ln in lines)
    # three runs of the same logs are not enough to decide
    res3, _ = _run(capsys, ["--jax", jax, "--port", *dirs[:3]] + AT)
    assert res3["verdict"] == "undecided"


def test_rule_a_counts_only_validations_every_run_has(tmp_path, capsys):
    jax = _write(tmp_path / "jax", JAX)
    short = _write(tmp_path / "short", {20: 4.2, 40: 4.2})  # a 40-step run
    res, lines = _run(capsys, ["--jax", jax, "--port", short] + AT)
    a = res["rule_a"]
    assert a["n_above"] == 0 and a["missing"] == [3000, 3500, 4500]
    assert a["best_above"] and res["verdict"] == "undecided"
    assert "| 20 | - | 4.2 | 4.2 | 4.2 | 4.2 |" in lines
    assert "| 3000 | 40.0 | - | - | - | - |" in lines
    # four runs, three of them past the JAX run everywhere and one cut short:
    # the short run's missing validations leave the verdict undecided
    full = [_write(tmp_path / f"full{i}", {3000: 70.0, 3500: 71.0, 4500: 72.0, 5000: 73.0})
            for i in range(4)]
    res4, _ = _run(capsys, ["--jax", jax, "--port", short, *full[:3]] + AT)
    a4 = res4["rule_a"]
    assert a4["runs"] == 4 and a4["missing"] == [3000, 3500, 4500]
    assert a4["faults"] == 0 and res4["verdict"] == "undecided"
    res_full, _ = _run(capsys, ["--jax", jax, "--port", *full] + AT)
    assert res_full["rule_a"]["missing"] == [] and res_full["verdict"] == "spread"


def test_pair_mode_reads_the_committed_gmm_ab_ordering(capsys):
    fixed, gmm = os.path.join(WORK, "gmmab_fixed_r5"), os.path.join(WORK, "gmmab_gmm_r5")
    res, lines = _run(capsys, ["--jax", fixed, gmm, "--pair", fixed, gmm])
    p = res["pair"]
    assert p["ordering_held"] and res["verdict"] == "held"
    assert p["jax_gap"] == pytest.approx(60.51 - 23.29, abs=1e-2)
    assert p["fixed"]["meets"] and p["gmm"]["meets"]
    assert p["fixed"]["need"] == pytest.approx(0.85 * 60.5068, abs=1e-3)
    # the arms swapped: each misses its bar or not, and the ordering fails
    res2, _ = _run(capsys, ["--jax", fixed, gmm, "--pair", gmm, fixed])
    assert not res2["pair"]["ordering_held"] and res2["verdict"] == "not held"
    assert not res2["pair"]["fixed"]["meets"] and res2["pair"]["gmm"]["meets"]


def test_pair_mode_on_the_committed_port_gmm_ab(capsys):
    res, lines = _run(capsys, ["--jax", os.path.join(WORK, "gmmab_fixed_r5"),
                               os.path.join(WORK, "gmmab_gmm_r5"), "--pair",
                               os.path.join(WORK, "torch_gmmab_fixed_h100"),
                               os.path.join(WORK, "torch_gmmab_gmm_h100")])
    p = res["pair"]
    assert not p["ordering_held"] and res["verdict"] == "not held"
    assert p["port_gap"] == pytest.approx(43.18 - 44.85, abs=1e-2)  # -1.66
    assert not p["fixed"]["meets"] and p["fixed"]["port_best"] == pytest.approx(43.18, abs=5e-3)
    # the GMM arm clears its bar from above: 1.93x the JAX arm's best
    assert p["gmm"]["meets"] and p["gmm"]["over_jax"] == pytest.approx(44.85 / 23.29, abs=1e-3)
    assert any("(1.93x the JAX arm's best)" in ln for ln in lines)


def test_usage_errors():
    with pytest.raises(SystemExit):
        report_parity.main(["--jax", "a", "b", "--port", "c"])
    with pytest.raises(SystemExit):
        report_parity.main(["--jax", "a", "--pair", "b", "c"])
