"""Traffic generator ``train``: the program's co-training step,
``train/step.py::build_train_step``, driven step after step over a ring of
``ring`` distinct batches drawn from the seed and kept on the card as
uint8: smooth random colour fields at the crop (the weak view) and a
photometric jitter of each (the strong view), image labels with the
configuration's mean count per image, and crop boxes of a fixed set of
sizes at seeded places. Every seed gives the same sizes and counts in
another order, so the work is the same.

Set-up builds the program's training state (``create_train_state``),
loads the benchmark's weights into it, sets its step counter (``start``:
``after_warmup`` puts it past the loss warm-up, where every loss term
carries gradient), and drives it through ``check_steps`` steps by the
window's own call, recording what the check compares, then
``warmup_steps`` more. In the first step the check also keeps what the
step's own calls produced: the teacher's TTA (``multi_scale_camseg``), the
pseudo masks (``cam2mask``), the soft targets (``seg_refine_by_label``),
each looked up by ``train/step.py`` at call time and wrapped for that step
alone, and the student's outputs (a forward hook). The check runs the plain
reference over the same weights and batches for ``check_steps`` steps.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from benchmark import check, weights
from benchmark.reference.cosa import FAULTS, TrainStep
from benchmark.reference.model import weight_shapes

SPANS = ("bench.call", "teacher_tta", "gmm", "pseudo_labels", "student_forward",
         "losses", "energy", "backward", "optimizer", "ema")
LOSSES = ("overall_loss", "cls_loss", "cls_aux_loss", "seg_loss", "cam_loss", "reg_loss")
BOX_SIDES = (1.0, 1.0, 1.0, 1.0, 0.875, 0.75, 0.625, 0.5)  # crop-box sides as shares of the crop


def label_counts(n: int, mean: float) -> np.ndarray:
    """``n`` per-image label counts whose mean is ``mean`` (to 1/n)."""
    base = int(math.floor(mean))
    extra = int(round((mean - base) * n))
    return np.array([base + 1] * extra + [base] * (n - extra), np.int64)


def staged_batches(c: Dict, data: Dict, ring: int, seed: int, device) -> List[Dict]:
    """The ring of staged batches (module docstring)."""
    b, s, n_fg = c["batch_size"], c["crop_size"], c["num_classes"] - 1
    n = ring * b
    g = weights.generator(weights.subseed(seed, 3), device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    field = (0.7 * F.interpolate(rand(n, 3, 7, 7), (s, s), mode="bicubic", align_corners=False)
             + 0.3 * F.interpolate(rand(n, 3, 28, 28), (s, s), mode="bilinear", align_corners=False)
             + 0.03 * torch.randn((n, 3, s, s), generator=g, device=device))
    weak = field.clamp(0, 1) * 255
    strong = (weak - 128) * (0.6 + 0.8 * rand(n, 1, 1, 1)) + 128 + 50 * (rand(n, 1, 1, 1) - 0.5)

    def u8(x):
        return x.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()

    order = torch.randperm(n, generator=g, device=device).cpu().numpy()
    counts = torch.from_numpy(label_counts(n, data["mean_labels_per_image"])[order]).to(device)
    rank = rand(n, n_fg).argsort(dim=1).argsort(dim=1)
    labels = (rank < counts[:, None]).to(torch.float32)
    sides = np.array([BOX_SIDES[i % len(BOX_SIDES)] for i in order])
    hw = np.stack([sides, sides[::-1]], 1) * s
    hw = hw.astype(np.int64)
    off = (rand(n, 2).cpu().numpy() * (s - hw + 1)).astype(np.int64)
    box = torch.from_numpy(np.stack([off[:, 0], off[:, 0] + hw[:, 0], off[:, 1],
                                     off[:, 1] + hw[:, 1]], 1).astype(np.int32)).to(device)
    wimg, simg = u8(weak), u8(strong)
    return [dict(wimg=wimg[i * b:(i + 1) * b], simg=simg[i * b:(i + 1) * b],
                 cls_label=labels[i * b:(i + 1) * b], img_box=box[i * b:(i + 1) * b])
            for i in range(ring)]


def start_step(c: Dict, mix: Dict) -> int:
    return c["warmup_iters"] + 1 if mix.get("start") == "after_warmup" else 0


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32, copy=True)


def _keep(t: torch.Tensor) -> torch.Tensor:
    """A host copy in the tensor's own type (the check widens it)."""
    return t.detach().to("cpu", copy=True)


@contextlib.contextmanager
def first_step_outputs(port_step, student: torch.nn.Module, into: Dict):
    """Keep in ``into`` what one step's own calls produce: ``cam``,
    ``cam_aux`` and ``seg`` of the teacher's TTA, ``soft`` the soft CAM
    targets, ``mask`` and ``mask_aux`` the pseudo masks of both heads (in
    the step's order of calls) and ``seg_logits`` the student's. The
    step's module looks these functions up when it calls them, so each is
    wrapped in its module for the step and put back after it."""
    saved = {n: getattr(port_step, n) for n in ("multi_scale_camseg", "cam2mask",
                                                 "seg_refine_by_label")}
    masks = ("mask", "mask_aux")

    def tta(*a, **k):
        out = saved["multi_scale_camseg"](*a, **k)
        into.update(zip(("cam", "cam_aux", "seg"), map(_keep, out)))
        return out

    def mask(*a, **k):
        out = saved["cam2mask"](*a, **k)
        into[masks[sum(m in into for m in masks)]] = _keep(out)
        return out

    def soft(*a, **k):
        out = saved["seg_refine_by_label"](*a, **k)
        into["soft"] = _keep(out)
        return out

    def hook(module, args, out):
        into.setdefault("seg_logits", _keep(out["seg"]))

    handle = student.register_forward_hook(hook)
    for name, fn in (("multi_scale_camseg", tta), ("cam2mask", mask),
                     ("seg_refine_by_label", soft)):
        setattr(port_step, name, fn)
    try:
        yield into
    finally:
        handle.remove()
        for name, fn in saved.items():
            setattr(port_step, name, fn)


class TrainWorkload:
    spans = SPANS

    def __init__(self, ctx):
        import cosa_tpu_torch.train.state as port_state
        import cosa_tpu_torch.train.step as port_step

        self.ctx = ctx
        c, mix, dev = ctx.config["config"], ctx.traffic, ctx.device
        self.c, self.mix = c, mix
        self.port_step = port_step
        marks = ctx.setup_marks
        cfg = ctx.port_config()
        self.batches = staged_batches(c, ctx.config["data"], mix["ring"], ctx.seed, dev)
        marks.mark("inputs")
        self.state = port_state.create_train_state(cfg, dev)
        marks.mark("create_train_state")
        student, teacher = weights.network_weights(
            weight_shapes(ctx.config["widths"], c["num_classes"]), ctx.seed, dev)
        self.state.student.load_state_dict(student)
        self.state.teacher.load_state_dict(teacher)
        del student, teacher
        marks.mark("weights")
        self.state.step = start_step(c, mix)
        self.step = port_step.build_train_step(cfg)
        self.i = 0
        self.record = self._first_steps(mix["check_steps"])
        marks.mark("checked_steps")
        for _ in range(mix["warmup_steps"]):
            self.call()
        marks.mark("warmup_steps")

    def call(self) -> int:
        batch = self.batches[self.i % len(self.batches)]
        self.i += 1
        with record_function("bench.call"):
            self.last = self.step(self.state, batch)
        return int(batch["wimg"].shape[0])

    trace_call = call

    @property
    def trace_units(self) -> int:
        return int(self.mix["trace_steps"])

    def _first_steps(self, n: int) -> Dict:
        """The first ``n`` steps through the window's call, and what the check
        compares: each step's losses, the first step's image-level logits of
        both heads and the outputs of its own calls (:func:`first_step_outputs`),
        the first gradient as the optimizer holds it after one step (AdamW's
        first moment over 1 - beta1), and the student's and the teacher's
        weights after the ``n`` steps."""
        student = dict(self.state.student.named_parameters())
        opt = self.state.optimizer.opt
        losses, grads, first = [], {}, {}
        for k in range(n):
            with (first_step_outputs(self.port_step, self.state.student, first) if k == 0
                  else contextlib.nullcontext()):
                self.call()
            losses.append({name: float(self.last[name]) for name in LOSSES})
            if k == 0:
                logits = _host(torch.cat([self.last["cls_logits"], self.last["cls_aux_logits"]], 1))
                beta1 = opt.param_groups[0]["betas"][0]
                grads = {name: _host(opt.state[p]["exp_avg"]) / (1 - beta1)
                         for name, p in student.items() if p in opt.state}
        return dict(losses=losses, grads=grads, logits=logits, first=first,
                    student={k: _host(v) for k, v in student.items()},
                    teacher={k: _host(v) for k, v in self.state.teacher.named_parameters()})

    def attempted(self, window: Dict) -> int:
        return window["calls"]

    def check(self) -> Dict[str, float]:
        """Free the program's state, run the plain reference over the same
        weights and the first batches, and compare (benchmark/check.py)."""
        dev = self.ctx.device
        first = self.batches[:self.mix["check_steps"]]
        self.state = self.step = self.last = self.batches = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return reference_numbers(self.ctx.config, self.mix, self.ctx.seed, first,
                                 self.record, dev)


def reference_run(config: Dict, mix: Dict, seed: int, batches: List[Dict], device,
                  precision: str = "f32", fault: str = "") -> Dict:
    """The plain reference's record of the first steps, in the shape of
    :meth:`TrainWorkload._first_steps`'s: ``precision`` "f32" is the
    reference, "fp8" the control put in the program's place; ``fault`` one
    of reference/cosa.py's planted faults."""
    c = config["config"]
    student, teacher = weights.network_weights(
        weight_shapes(config["widths"], c["num_classes"]), seed, device)
    ref = TrainStep(c, config["widths"], student, teacher, start_step(c, mix), precision, fault)
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
    """The run's initial weights on the host, as the check's changes start."""
    c = config["config"]
    student, teacher = weights.network_weights(
        weight_shapes(config["widths"], c["num_classes"]), seed, device)
    return dict(student={k: _host(v) for k, v in student.items()},
                teacher={k: _host(v) for k, v in teacher.items()})


def reference_numbers(config, mix, seed, batches, record, device) -> Dict[str, float]:
    init = initial(config, seed, device)
    ref = reference_run(config, mix, seed, batches, device)
    return check.train_numbers(record, ref, init)


def control_numbers(ctx) -> Dict[str, Dict[str, float]]:
    """The control (the reference in float8 operands) and the planted faults
    (reference/cosa.py's ``FAULTS``), each put in the program's place and
    held against the reference."""
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


def build(ctx) -> TrainWorkload:
    return TrainWorkload(ctx)
