"""The benchmark's Swin-B cell (``swin_b.train_staged``) on the CPU at
``swin_tiny_test`` widths: the plain reference (benchmark/reference/swin.py)
against the port's SwinNetwork and step, the drop-path draws, a planted
fault, the counts (benchmark/counts/swin.py) against the program's FLOPs and
its ``WINDOW_ATTN`` counter, and the cell's files found by name.

The tiny network has two blocks a stage (so every stage has a shifted
block) and drop path 0.3 (set on the program's ``swin_tiny_test`` entry for
the test); its window of 4 pads the grid at every TTA scale of a 64 crop
(stage 3's 2 x 2 grid at scale 1, stage 2's 6 x 6 at scale 1.5).

Tolerances: in float32 the program and the reference compute the same
products in the same order on the CPU, so they agree to 1e-5 relative (the
room of a different order of summation; they read 0 here). In bfloat16
each product's operands round to 8 bits (2^-8 relative) and the errors of
8 blocks and the decoder add: the outputs read 0.6-1.5e-2 relative over
three seeds, and 4e-2 leaves room for other seeds."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.control import readings
from benchmark.counts import Forward
from benchmark.counts import swin as counts
from benchmark.reference.swin import SwinNetwork, drop_path_generator
from benchmark.run import Context, _merge, run_cell
from benchmark.traffic.train import staged_batches
from benchmark.traffic.train_swin import network_weights, port_names
from cosa_tpu_torch.models.network import build_model
from cosa_tpu_torch.models.zoo import swin as tswin
from cosa_tpu_torch.train import step as port_step

ROOT = Path(__file__).resolve().parents[1]
CELL = "swin_b.train_staged"
SEED = 2 ** 31 + 4321  # more than 32 signed bits, as a benchmark seed may be
WIDTHS = dict(embed_dim=16, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8], window=4,
              drop_path_rate=0.3)
TRAIN = {"config": {"config": {"backbone": "swin_tiny_test", "crop_size": 64, "batch_size": 2},
                    "widths": WIDTHS},
         "traffic": {"ring": 3, "warmup_steps": 1, "trace_steps": 2}}
F32_REL, BF16_REL = 1e-5, 4e-2
EMA_F32 = 1e-3
VIT_ONLY = ("mfu.train", "attn_fwd_roofline.train", "attn_bwd_roofline.train",
            "teacher_tta_device_ms.train", "tta_forward_idle_ms.train", "tta_fuse_idle_ms.train")
SWIN_METRICS = ("mfu_swin.train", "window_attn_device_ms.train", "window_attn_fwd_roofline.train")


@pytest.fixture(autouse=True)
def tiny_swin(monkeypatch):
    """The tiny network above, on one torch thread (beside the other test
    workers: several threads a worker oversubscribe the cores)."""
    tiny = tswin.SWIN_CONFIGS["swin_tiny_test"]
    monkeypatch.setitem(tswin.SWIN_CONFIGS, "swin_tiny_test", dataclasses.replace(
        tiny, depths=tuple(WIDTHS["depths"]), drop_path_rate=WIDTHS["drop_path_rate"]))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _over(**config):
    over = json.loads(json.dumps(TRAIN))
    over["config"]["config"].update(config)
    return over


def _cell(**config):
    cell = harness.find_cell(CELL)
    for key, over in _over(**config).items():
        setattr(cell, key, _merge(getattr(cell, key), over))
    return cell


def _program_and_reference(mixed_precision: bool, seed: int):
    cell = _cell(mixed_precision=mixed_precision)
    student, _ = network_weights(cell.config, seed, "cpu")
    cfg = Context(cell, seed, torch.device("cpu"), "").port_config()
    net = build_model(cfg, "cpu")
    to_port = port_names(student)
    net.load_state_dict({to_port[k]: v for k, v in student.items()})
    c = cell.config["config"]
    return net, SwinNetwork(cell.config["widths"], c["aux_layer"]), student


def _rel(p, r) -> float:
    return float((p.double() - r.double()).norm() / r.double().norm())


@pytest.mark.parametrize("mixed_precision,tol", [(False, F32_REL), (True, BF16_REL)])
def test_reference_forward_matches_the_port(mixed_precision, tol):
    """Every output of the port's SwinNetwork against the reference's, on
    a 60 x 52 image (a grid that pads at every stage)."""
    net, ref, w = _program_and_reference(mixed_precision, 11)
    x = torch.randn((2, 60, 52, 3), generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        out, want = net(x), ref(x, w)
    for k in ("cls", "cls_aux", "seg", "cam", "cam_aux"):
        assert out[k].shape == want[k].shape, k
        assert _rel(out[k], want[k]) < tol, k


def test_drop_path_masks_equal_the_ports_draws(monkeypatch):
    """The student's forward at one step: the samples each residual branch
    drops, in the program (``DropPath`` with the step's generator) and in
    the reference (its own generator by the stated rule), and the outputs."""
    net, ref, w = _program_and_reference(False, 12)
    seed, step = 2 ** 40 + 5, 6001
    dropped = {"port": [], "ref": []}
    port_drop, ref_drop = tswin.DropPath.forward, SwinNetwork._drop

    def port(self, x, train=False, generator=None):
        y = port_drop(self, x, train, generator)
        if train and 0.0 < self.p < 1.0:
            dropped["port"].append((y == 0).flatten(1).all(1).tolist())
        return y

    def plain(self, y, rate):
        out = ref_drop(self, y, rate)
        if self.drop is not None and 0.0 < rate < 1.0:
            dropped["ref"].append((out == 0).flatten(1).all(1).tolist())
        return out

    monkeypatch.setattr(tswin.DropPath, "forward", port)
    monkeypatch.setattr(SwinNetwork, "_drop", plain)
    x = torch.randn((4, 64, 64, 3), generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        out = net(x, train=True, generator=port_step.drop_path_generator(seed, step, "cpu"))
        ref.drop = drop_path_generator(seed, step, "cpu")
        want = ref(x, w)
    assert dropped["port"] == dropped["ref"]
    assert len(dropped["ref"]) == 2 * (sum(WIDTHS["depths"]) - 1)  # block 0's rate is 0
    assert any(any(d) for d in dropped["ref"]) and not all(all(d) for d in dropped["ref"])
    for k in ("cls", "seg", "cam_aux"):
        assert _rel(out[k], want[k]) < F32_REL, k


def test_a_whole_step_matches_the_reference_in_float32():
    """TTA, pseudo masks, soft targets, losses, the update and the EMA of
    three steps through the cell's own run, against the reference."""
    numbers = run_cell(CELL, SEED, 0.2, False, "cpu", _over(mixed_precision=False))["numbers"]
    for k in ("logit_err", "tta_err", "soft_err", "seg_err", "loss_gap", "grad_gap",
              "grad_err", "update_gap"):
        assert numbers[k] < F32_REL, k
    # a block whose branch drops both samples of the first batch has no first
    # gradient, so the check's filter of entries moved by round-off alone (the
    # key's bias, benchmark/check.py) passes it over, and Adam moves those
    # entries by the sign of round-off in the later steps: 4.5e-5 at this seed
    assert numbers["ema_gap"] < EMA_F32, numbers["ema_gap"]
    assert numbers["mask_flip"] == 0.0 and numbers["update_sign"] == 0.0


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_rehearsal_ends_in_one_correct_line(trace):
    line = run_cell(CELL, SEED, 0.2, trace, "cpu", TRAIN)
    json.dumps(line)
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert line["metrics"] == {} and line["device"]["platform"] == "cpu"
    assert set(line["checks"]) == set(harness.find_cell(CELL).limits)


def test_the_planted_faults_and_the_control_read_not_correct():
    """At the program's bfloat16, the cell's limits pass the program and
    fail the float8 control, the losses over half of each batch and the
    update taken the wrong way."""
    rows = readings(CELL, [SEED], True, True, "cpu", TRAIN)
    by = {r["reading"]: r for r in rows}
    limits = harness.find_cell(CELL).limits
    assert harness.judge(by["program"], limits)
    for bad in ("control", "half_loss", "flipped_update"):
        assert not harness.judge(by[bad], limits), bad
    assert by["half_loss"]["loss_gap"] > 3 * by["program"]["loss_gap"]


def test_window_attention_counts_equal_the_programs_counter():
    """One step of the program: ``WINDOW_ATTN``'s calls, windows and masked
    calls equal the counts' list of the step's calls (the TTA's three
    scales and the student, 8 blocks each)."""
    cell = _cell(mixed_precision=False)
    c = cell.config["config"]
    cfg = Context(cell, 3, torch.device("cpu"), "").port_config()
    from cosa_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, "cpu")
    state.step = cfg.warmup_iters + 1
    batch = staged_batches(c, cell.config["data"], 1, 3, "cpu")[0]
    step = port_step.build_train_step(cfg)
    before = dict(tswin.WINDOW_ATTN)
    step(state, batch)
    seen = {k: tswin.WINDOW_ATTN[k] - before[k] for k in before}
    calls = counts.train_step_window_calls(c, cell.config["widths"])
    assert seen == {"calls": len(calls), "windows": sum(x.batch * x.windows for x in calls),
                    "masked_calls": sum(x.masked for x in calls)}
    assert len(calls) == 4 * sum(WIDTHS["depths"])
    assert 0 < seen["masked_calls"] < seen["calls"]


def test_step_flops_equal_the_flop_counter():
    """The analytic count of the tiny step equals FlopCounterMode over the
    program's float32 step (every product counted once, no other)."""
    from torch.utils.flop_counter import FlopCounterMode

    from cosa_tpu_torch.cli.bench import bmm_flops
    from cosa_tpu_torch.train.state import create_train_state

    cell = _cell(mixed_precision=False)
    c = cell.config["config"]
    cfg = Context(cell, 3, torch.device("cpu"), "").port_config()
    state = create_train_state(cfg, "cpu")
    state.step = cfg.warmup_iters + 1
    batch = staged_batches(c, cell.config["data"], 1, 3, "cpu")[0]
    step = port_step.build_train_step(cfg)
    with FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: bmm_flops}) as fc:
        step(state, batch)
    assert counts.train_step_flops(c, cell.config["widths"]) == fc.get_total_flops()


def test_full_width_counts():
    """Swin-B at the cell's sizes: 96 window attentions a step (24 blocks x
    3 TTA scales and the student), of which 47 carry a mask (every second
    block of a stage wider than one window: 12 a forward, 11 at scale 0.5,
    where stage 3's 7 x 7 grid is one window); 49 tokens and head width 32;
    no padding at any scale."""
    cell = harness.find_cell(CELL)
    c, widths = cell.config["config"], cell.config["widths"]
    calls = counts.train_step_window_calls(c, widths)
    assert len(calls) == 96 and sum(x.masked for x in calls) == 47
    assert {(x.tokens, x.head_dim) for x in calls} == {(49, 32)}
    for s in c["pseudo_scales"]:
        grids = counts.stage_grids(widths, int(448 * s), int(448 * s))
        assert all(g % 7 == 0 for grid in grids for g in grid)
    flops = counts.train_step_flops(c, widths)
    student = counts.network_flops(widths, 21, -3, Forward(4, 448, 448, True))
    assert 4.5e12 < flops < 5.5e12 and student < flops / 3


def test_the_configuration_is_the_programs_swin_b():
    """The configuration's widths are the published Swin-B's, as the
    program builds it, with nothing reduced."""
    cell = harness.find_cell(CELL)
    w, c = cell.config["widths"], cell.config["config"]
    b = dataclasses.asdict(tswin.SWIN_CONFIGS["swin-b"])
    assert {k: w[k] for k in b} == {k: list(v) if isinstance(v, tuple) else v
                                    for k, v in b.items()}
    assert (w["embed_dim"], w["depths"], w["num_heads"], w["window"]) == (
        128, [2, 2, 18, 2], [4, 8, 16, 32], 7)
    assert (w["decoder_dim"], w["decoder_dilation"]) == (512, 5)
    assert (c["model"], c["backbone"], c["aux_layer"]) == ("swinend2end", "swin-b", -3)
    assert cell.config["reduced"] == [] and cell.config["assumed"]
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry, = [x for x in spec["configs"] if x["name"] == cell.config["name"]]
    assert entry["reduced"] == [] and entry["file"] == "benchmark/configs/cosa_swinb_voc.json"


def test_the_cell_finds_every_reader_and_no_vit_only_metric():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(CELL)
    e2e = [m["name"] for m in cell.end_to_end]
    layer = [m["name"] for m in cell.per_layer]
    assert set(e2e) == {"train_img_per_s", "step_ms_p95", "peak_mem_gib", "setup_s"}
    assert set(layer) == {"idle_share.train", *SWIN_METRICS}
    assert not set(VIT_ONLY) & set(layer)
    for m in cell.end_to_end + cell.per_layer:
        mod = harness.load_module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py")
        assert mod.SOURCE == m["source"] and callable(mod.read)
    for m in spec["per_layer"]:
        if m["name"] in SWIN_METRICS:
            assert m["workloads"] == [CELL] and m["moves"] == "train_img_per_s"
    assert cell.generator.SPANS[-1] == "window_attn"
    assert harness.find_cell("voc.train_staged").generator.SPANS == cell.generator.SPANS[:-1]


def test_the_readers_on_a_reduction():
    """The span readers read the device time under ``window_attn`` a step
    and read nothing for a program without the span; the roofline is the
    counts' least time over that time."""
    cell = harness.find_cell(CELL)
    window = {"calls": 10, "images": 40, "seconds": 2.0, "call_s": [0.2] * 10}
    red = {"units": 4, "busy_s": 0.8, "device_s": {"window_attn": 0.04, "teacher_tta": 0.3}}
    got = harness.read_metrics(cell, cell.per_layer, harness.Reading(
        cell.config, cell.traffic, window, red))
    assert got["window_attn_device_ms.train"]["value"] == pytest.approx(10.0)
    bound = counts.window_attn_bound_s(cell.config["config"], cell.config["widths"])
    assert got["window_attn_fwd_roofline.train"]["value"] == pytest.approx(100 * bound / 0.01)
    flops = counts.train_step_flops(cell.config["config"], cell.config["widths"])
    assert got["mfu_swin.train"]["value"] == pytest.approx(100 * flops * 5 / 989e12)
    parent = dict(red, device_s={"teacher_tta": 0.3})
    got = harness.read_metrics(cell, cell.per_layer, harness.Reading(
        cell.config, cell.traffic, window, parent))
    assert set(got) == {"mfu_swin.train", "idle_share.train"}


def test_the_reference_imports_nothing_of_the_program_or_jax():
    code = ("import benchmark.reference.swin, benchmark.counts.swin, sys\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    mods = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not {"cosa_tpu_torch", "cosa_tpu", "jax", "jaxlib", "flax"} & mods


def test_the_span_costs_no_record_function_untraced_and_names_each_block_traced(monkeypatch):
    """Untraced, a forward opens no ``record_function`` (the span is the
    shared do-nothing context); profiled, it names one ``window_attn`` a
    block, and ``WINDOW_ATTN`` counts the same calls either way."""
    from torch.profiler import ProfilerActivity, profile

    from cosa_tpu_torch.utils import trace

    net, _, _ = _program_and_reference(True, 13)
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(13))
    opened = []
    real = trace.record_function
    monkeypatch.setattr(trace, "record_function", lambda name: opened.append(name) or real(name))
    before = tswin.WINDOW_ATTN["calls"]
    with torch.no_grad():
        net(x)
        assert opened == [] and tswin.WINDOW_ATTN["calls"] == before + 8
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            net(x)
    assert opened == ["window_attn"] * 8 and tswin.WINDOW_ATTN["calls"] == before + 16
    assert sum(e.name == "window_attn" for e in prof.events()) == 8
