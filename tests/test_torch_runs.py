"""PyTorch port: the run presets, run reports and VOC parity harness
against the JAX package's scripts.

Each preset of cli/run_synth.py parses to the Config that the JAX
package's parse_cli makes of its script's flags, read from the script's
own text (swinsynth, which has no script, to the config its run printed);
the reports print what the JAX scripts print on the committed runs; the
parity harnesses print the same table and return the same exit code on
the same finaleval result; and a preset trains end to end on the CPU."""

import ast
import dataclasses
import importlib.util
import json
import os
import shlex
import sys

import pytest

import cosa_tpu.train.loop as jax_loop
import cosa_tpu_torch.train.loop as torch_loop
from cosa_tpu.config import parse_cli as jax_parse_cli
from cosa_tpu_torch.cli import chip_run, make_synth_data, parity_voc, report_gmm_ab
from cosa_tpu_torch.cli import report_synth, run_synth
from cosa_tpu_torch.config import diff_from_preset, parse_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
WORK = os.path.join(ROOT, "work_dirs")
VOC_ROOT = "/data/VOC2012"  # a stand-in for the run scripts' $VOC_ROOT / $COCO_ROOT


def _script(name):
    """(make_synth_data's arguments or None, [each training command's
    arguments after the module]) of a run script, from its text."""
    with open(os.path.join(SCRIPTS, name)) as f:
        text = f.read().replace("\\\n", " ")
    env = {"$VOC_ROOT": VOC_ROOT, "$COCO_ROOT": VOC_ROOT}
    common, data, runs = [], None, []
    lines = iter(text.splitlines())
    for line in lines:
        line = line.strip()
        if line.startswith("common=("):  # a bash array over several lines
            while not line.endswith(")"):
                line += " " + next(lines).strip()
            common = shlex.split(line[len("common=("):-1])
        elif "scripts/make_synth_data.py" in line and not line.startswith("#"):
            words = shlex.split(line)
            data = words[words.index("scripts/make_synth_data.py") + 1:]
        elif line.startswith("python -m cosa_tpu.cli.train"):
            args = []
            for w in shlex.split(line)[3:]:
                if w == "${common[@]}":
                    args += common
                elif w != "$@":
                    args.append(env.get(w, w))
            runs.append(args)
    return data, runs


# preset: (script, training command, extra flags "$@" passes, script's NAME)
SCRIPTED = {
    "synthrun": ("run_synth.sh", 0, [], "synthrun_r3"),
    "synthrun_gmm": ("run_synth.sh", 0, ["--usegmm", "true"], "synthrun_gmm"),
    "synthcoco": ("run_synth_coco.sh", 0, [], "synthcoco_r4"),
    "gmmab_fixed": ("run_gmm_ab.sh", 0, [], None),
    "gmmab_gmm": ("run_gmm_ab.sh", 1, [], None),
    "voc": ("run_voc.sh", 0, [], None),
    "coco": ("run_coco.sh", 0, [], None),
}


def _assert_same_config(port, jax_cfg):
    a, b = dataclasses.asdict(port), dataclasses.asdict(jax_cfg)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == b[k], (k, a[k], b[k])


def test_every_preset_is_checked():
    assert set(SCRIPTED) | {"swinsynth"} == set(run_synth.PRESETS)


@pytest.mark.parametrize("preset", sorted(SCRIPTED))
def test_preset_config_equals_jax_parse_of_script(preset):
    script, which, extra, name = SCRIPTED[preset]
    data, runs = _script(script)
    args = runs[which]
    if name is not None:
        assert args[0] == "$NAME"
    else:
        name = args[0].replace("$SUFFIX", "")  # the arm's name: gmmab_fixed, voc_cosa
    args = [name] + args[1:]
    port_extra = ["--data_root", VOC_ROOT] if preset in ("voc", "coco") else []
    port = parse_cli(run_synth.train_argv(preset, name, port_extra))
    _assert_same_config(port, jax_parse_cli(args + extra))
    p = run_synth.PRESETS[preset]
    assert p.name == (name if preset in ("voc", "coco") else preset)
    if data is None:
        assert p.data == ()
    else:  # the dataset is written where the run reads it, as the script writes it
        assert data[:2] == ["--root", port.data_root]
        assert list(p.data) == data[2:]
        assert p.marker(port.data_root).endswith("train2014" if "coco" in data else "JPEGImages")


def _printed_diff(run_dir):
    with open(os.path.join(WORK, run_dir, "print.out")) as f:
        first = f.readline()
    return ast.literal_eval(first.split(" preset: ", 1)[1])


def test_swinsynth_preset_is_its_printed_config():
    want = _printed_diff("swinsynth_r4")
    cfg = parse_cli(run_synth.train_argv("swinsynth", want["name"]))
    got = diff_from_preset(cfg)
    got.pop("work_dir", None)
    want.pop("work_dir", None)
    assert got == want


@pytest.mark.parametrize("preset,run_dir", [
    ("synthrun", "synthrun_r3"), ("synthcoco", "synthcoco_r5"),
    ("gmmab_fixed", "gmmab_fixed_r5"), ("gmmab_gmm", "gmmab_gmm_r5")])
def test_preset_config_equals_committed_run(preset, run_dir):
    """The committed JAX runs printed the config each preset makes."""
    want = _printed_diff(run_dir)
    got = diff_from_preset(parse_cli(run_synth.train_argv(preset, want["name"])))
    got.pop("work_dir", None)
    want.pop("work_dir", None)
    if preset == "gmmab_fixed":  # --usegmm false is the preset's default
        assert "usegmm" not in want
    assert got == want


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", os.path.join(SCRIPTS, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_main(monkeypatch, capsys, name, argv):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    rc = _jax_script(name).main()
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("run_dir", ["synthrun_r3", "synthrun_gmm", "swinsynth_r4",
                                     "synthcoco_r5", "gmmab_gmm_r5", "torch_synthrun_h100",
                                     "torch_synthrun_seed1_h100"])
def test_report_synth_prints_as_jax(monkeypatch, capsys, run_dir):
    argv = ["--out_dir", os.path.join(WORK, run_dir), "--data_root", "unused", "--panels", "0"]
    _, want = _jax_main(monkeypatch, capsys, "report_synth.py", argv)
    report_synth.main(argv)
    got = capsys.readouterr().out
    assert got == want
    assert "Best val Seg mIoU" in got and got.count("\n| ") > 5


def test_report_gmm_ab_prints_as_jax(monkeypatch, capsys):
    argv = ["--fixed", os.path.join(WORK, "gmmab_fixed_r5"),
            "--gmm", os.path.join(WORK, "gmmab_gmm_r5")]
    _, want = _jax_main(monkeypatch, capsys, "report_gmm_ab.py", argv)
    report_gmm_ab.main(argv)
    got = capsys.readouterr().out
    assert got == want and "gmm finaleval" in got


def test_expected_table_is_the_jax_copy():
    with open(os.path.join(SCRIPTS, "voc_expected_final.json")) as f:
        want = json.load(f)
    with open(parity_voc.EXPECTED) as f:
        got = json.load(f)
    want.pop("_source")
    got.pop("_source")
    assert got == want


@pytest.mark.parametrize("shift,rc", [
    ({}, 0),  # every class 0.6 points off, mIoU 0.3: inside both tolerances
    ({"bicycle": 1.5}, 1),  # one class outside --tol
    ({"mIoU": 0.7}, 1),  # the mIoU outside --miou_tol
])
def test_parity_voc_matches_jax(monkeypatch, capsys, shift, rc):
    with open(parity_voc.EXPECTED) as f:
        exp = json.load(f)
    from cosa_tpu_torch.data.datasets import VOC_CLASSES

    def family(fam, sign):
        iou = [(exp[fam][c] + sign * (0.6 + shift.get(c, 0.0))) / 100 for c in VOC_CLASSES]
        return {"iou": iou, "miou": (exp[fam]["mIoU"] + sign * (0.3 + shift.get("mIoU", 0.0)))
                / 100}

    res = {"Seg_vd": family("Seg_vd", 1.0), "Seg_crf": family("Seg_crf", -1.0)}
    seen = []

    def fake(cfg, device=None):
        seen.append(cfg)
        return res

    monkeypatch.setattr(jax_loop, "finaleval", fake)
    monkeypatch.setattr(torch_loop, "finaleval", fake)
    argv = ["w.pth", "--voc_root", VOC_ROOT]
    want_rc, want = _jax_main(monkeypatch, capsys, "parity_voc.py", argv)
    got_rc = parity_voc.main(argv)
    got = capsys.readouterr().out
    assert (got_rc, got) == (want_rc, want)
    assert got_rc == rc
    assert ("DIVERGES" in got) == bool(rc)
    _assert_same_config(seen[1], seen[0])


def test_run_synth_writes_missing_dataset(monkeypatch, tmp_path):
    """A preset writes its dataset, at the script's sizes, where the run
    reads it, and only when that holds no images."""
    calls = []
    monkeypatch.setattr(make_synth_data, "main", lambda argv: calls.append(("data", argv)))
    from cosa_tpu_torch.cli import train as cli_train

    monkeypatch.setattr(cli_train, "main", lambda argv: calls.append(("train", argv)))
    root = str(tmp_path / "faint")
    run_synth.main(["gmmab_gmm", "--data_root", root, "--device", "cpu"])
    assert calls == [
        ("data", ["--root", root, "--n_train", "3000", "--n_val", "200", "--seed", "0",
                  "--fade", "0.35", "1.0"]),
        ("train", ["gmmab_gmm", *run_synth.PRESETS["gmmab_gmm"].flags,
                   "--data_root", root, "--device", "cpu"])]
    os.makedirs(os.path.join(root, "JPEGImages"))
    calls.clear()
    run_synth.main(["gmmab_gmm", "ab", "--data_root", root])
    assert [c[0] for c in calls] == ["train"] and calls[0][1][0] == "ab"
    with pytest.raises(SystemExit, match="--data_root"):
        run_synth.main(["voc"])


def test_run_synth_end_to_end_cpu(tmp_path):
    root, work = str(tmp_path / "data"), str(tmp_path / "work")
    make_synth_data.main(["--root", root, "--n_train", "4", "--n_val", "2", "--seed", "0"])
    run_synth.main(["synthrun", "tiny", "--data_root", root,
                    "--split_dir", os.path.join(root, "splits"), "--backbone", "vit_tiny_test",
                    "--crop_size", "64", "--max_iters", "2", "--eval_iters", "2",
                    "--log_iters", "1", "--crf_reduce", "8", "--work_dir", work,
                    "--device", "cpu"])
    out = os.path.join(work, "tiny")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    kinds = [(r["kind"], r.get("iter"), r.get("model")) for r in recs]
    assert kinds == [("train", 1, None), ("train", 2, None), ("val", 2, "ON"),
                     ("val", 2, "AN"), ("final", None, None)]
    assert 0.0 <= recs[-1]["Seg_crf"] <= 1.0
    with open(os.path.join(out, "log_val.txt")) as f:
        assert f.readline().strip() == "iters:1"
    with open(os.path.join(out, "print.out")) as f:
        text = f.read()
    assert "Best val Seg mIoU" in text and "Final Model Result" in text
    assert "'warmup_gate_floor': 0.01" in text.splitlines()[0]
    stats = chip_run.summarise(out)
    assert stats["iters"] == 2 and stats["validations"] == 1
    assert stats["sec_per_iter"]["windows"] == 1
    assert stats["energy_convention"].startswith("energy convention auto-calibrated")


def test_itertime_stats_of_committed_run():
    with open(os.path.join(WORK, "synthrun_r3", "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    s = chip_run.itertime_stats(recs)
    assert s["windows"] == 499  # 500 windows of 20 iterations, less the first
    assert s["min"] <= s["q1"] <= s["median"] <= s["q3"] <= s["max"]


def test_mount_of_finds_the_longest_mount_point():
    point, fstype = chip_run.mount_of("/proc/self")
    assert point == "/proc" and fstype == "proc"
