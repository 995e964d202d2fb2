"""Traffic generator ``train_swin``: the ``train`` generator's step, ring of
staged batches, first-step records and check (traffic/train.py) over the
Swin CoSA network (``model`` ``swinend2end``), its student training with
stochastic depth live.

The weights are drawn by the benchmark's scheme (benchmark/weights.py)
under MMSWIN's published names (reference/swin.py), with the relative
position bias tables at N(0, 0.02) as Swin initialises them, and reach the
program through its own loader of mmseg Swin files
(models/convert.py::state_dict_from_mmseg_swin); what the check compares
is named back. The run's seed also sets the program's ``cfg.seed``, from
which its step draws the student's drop-path masks
(``train/step.py::drop_path_generator``); the plain reference
(reference/swin.py) draws them by the same stated rule. The profiled
steps also give device time to ``window_attn``, the window attention's
core in models/zoo/swin.py.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark import check, weights
from benchmark.reference.cosa import FAULTS
from benchmark.reference.swin import SwinTrainStep, weight_shapes
from benchmark.traffic import train
from benchmark.traffic.train import _host, _keep, staged_batches, start_step

SPANS = train.SPANS + ("window_attn",)
BIAS_STD = 0.02  # the relative-position bias tables' init (Swin's trunc_normal_(std=.02))


def drop_path_seed(seed: int) -> int:
    """The program's ``cfg.seed`` of a run: its drop-path draws' seed."""
    return weights.subseed(seed, 4)


def network_weights(config: Dict, seed: int, device):
    """(student, teacher) under MMSWIN's names: the teacher shares the
    student's backbone and draws its decoder and CAM heads apart."""
    c = config["config"]
    shapes = weight_shapes(config["widths"], c["num_classes"], c["aux_layer"])

    def draw(names, sub):
        out = weights.draw({k: shapes[k] for k in names}, weights.subseed(seed, sub), device)
        for k, v in out.items():
            if k.endswith("relative_position_bias_table"):
                out[k] = v * (BIAS_STD * math.sqrt(math.prod(v.shape[1:])))
        return out

    student = draw(shapes, 1)
    teacher = {**student, **draw([k for k in shapes if not k.startswith("backbone.")], 2)}
    return student, teacher


def port_names(names) -> Dict[str, str]:
    """MMSWIN name -> the program's, through the program's mmseg loader."""
    from cosa_tpu_torch.models.convert import state_dict_from_mmseg_swin

    out = {v: "backbone." + k for k, v in state_dict_from_mmseg_swin(
        {k: k for k in names if k.startswith("backbone.")}).items()}
    out.update({k: k for k in names if not k.startswith("backbone.")})
    return out


class SwinTrainWorkload(train.TrainWorkload):
    spans = SPANS

    def __init__(self, ctx):
        import cosa_tpu_torch.train.state as port_state
        import cosa_tpu_torch.train.step as port_step

        self.ctx = ctx
        c, mix, dev = ctx.config["config"], ctx.traffic, ctx.device
        self.c, self.mix = c, mix
        self.port_step = port_step
        marks = ctx.setup_marks
        cfg = ctx.port_config(seed=drop_path_seed(ctx.seed))
        self.batches = staged_batches(c, ctx.config["data"], mix["ring"], ctx.seed, dev)
        marks.mark("inputs")
        self.state = port_state.create_train_state(cfg, dev)
        marks.mark("create_train_state")
        student, teacher = network_weights(ctx.config, ctx.seed, dev)
        to_port = port_names(student)
        self.state.student.load_state_dict({to_port[k]: v for k, v in student.items()})
        self.state.teacher.load_state_dict({to_port[k]: v for k, v in teacher.items()})
        del student, teacher
        marks.mark("weights")
        self.state.step = start_step(c, mix)
        self.step = port_step.build_train_step(cfg)
        self.i = 0
        record = self._first_steps(mix["check_steps"])
        to_ref = {v: k for k, v in to_port.items()}
        for key in ("grads", "student", "teacher"):
            record[key] = {to_ref[k]: v for k, v in record[key].items()}
        self.record = record
        marks.mark("checked_steps")
        for _ in range(mix["warmup_steps"]):
            self.call()
        marks.mark("warmup_steps")

    def check(self) -> Dict[str, float]:
        """Free the program's state, run the plain reference over the same
        weights and the first batches, and compare (benchmark/check.py)."""
        dev = self.ctx.device
        first = self.batches[:self.mix["check_steps"]]
        self.state = self.step = self.last = self.batches = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return check.train_numbers(self.record, reference_run(
            self.ctx.config, self.mix, self.ctx.seed, first, dev),
            initial(self.ctx.config, self.ctx.seed, dev))


def reference_run(config: Dict, mix: Dict, seed: int, batches: List[Dict], device,
                  precision: str = "f32", fault: str = "") -> Dict:
    """traffic/train.py's ``reference_run`` over the Swin reference."""
    c = config["config"]
    student, teacher = network_weights(config, seed, device)
    ref = SwinTrainStep(c, config["widths"], student, teacher, start_step(c, mix), precision,
                        fault, drop_path_seed(seed))
    del student, teacher
    losses, grads = [], {}
    with check.exact_f32():
        for k, batch in enumerate(batches):
            losses.append(ref(batch))
            if k == 0:
                grads = {n: _host(p.grad) for n, p in ref.student.items() if p.grad is not None}
                logits = _host(ref.logits)
                first, ref.first = {k: _keep(v) for k, v in ref.first.items()}, {}
    return dict(losses=losses, grads=grads, logits=logits, first=first,
                student={k: _host(v) for k, v in ref.student.items()},
                teacher={k: _host(v) for k, v in ref.teacher.items()})


def initial(config: Dict, seed: int, device) -> Dict:
    student, teacher = network_weights(config, seed, device)
    return dict(student={k: _host(v) for k, v in student.items()},
                teacher={k: _host(v) for k, v in teacher.items()})


def control_numbers(ctx) -> Dict[str, Dict[str, float]]:
    """The control (the reference in float8 operands) and the planted
    faults, each put in the program's place and held against the
    reference."""
    c, mix, dev = ctx.config["config"], ctx.traffic, ctx.device
    batches = staged_batches(c, ctx.config["data"], mix["ring"], ctx.seed, dev)
    batches = batches[:mix["check_steps"]]
    init = initial(ctx.config, ctx.seed, dev)
    ref = reference_run(ctx.config, mix, ctx.seed, batches, dev)
    out = dict(control=check.train_numbers(
        reference_run(ctx.config, mix, ctx.seed, batches, dev, "fp8"), ref, init))
    for fault in FAULTS[1:]:
        out[fault] = check.train_numbers(
            reference_run(ctx.config, mix, ctx.seed, batches, dev, "f32", fault), ref, init)
    return out


def build(ctx) -> SwinTrainWorkload:
    return SwinTrainWorkload(ctx)
