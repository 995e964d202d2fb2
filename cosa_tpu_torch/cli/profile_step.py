"""Where the co-training step's time goes, on one GPU.

The port's counterpart of scripts/profile_step.py, with torch's profiler
beside the JAX script's pieces.

Pieces (the JAX script's). Each times one part of the VOC step (ViT-B/16,
crop 448, batch 4, bf16) on one fixed device batch, by cli/bench.py's
harness: 3 warm-up calls, then ``--iters`` calls on the host clock
ended by one synchronize. Its FLOPs are counted as cli/bench.py counts a
step (FlopCounterMode, the attention and the RFF embedding on their plain
versions), and on the card its achieved rate and MFU follow:

  full          the step, train/step.py::build_train_step
  teacher_tta   the uint8 normalize and the teacher's 3-scale x flip TTA
  student_grad  the student's forward, losses and energy, and the
                backward, with the pseudo targets held fixed
  update        PolyWarmupAdamW and the EMA teacher update

The pieces call the step's own parts (``build_train_step(cfg).pieces``),
so each runs the step's code; the pseudo labels are not a piece of their
own (as in the JAX script).

Spans. A ``torch.profiler`` window (CPU and CUDA activity) over ``--steps``
full steps after one wait and one warm-up step, each fed from a host batch
through train/loop.py::to_device as the training loop feeds it; the device
is synchronized at the end of the warm-up step and of the last step. The
chrome trace goes to ``--out`` (gzipped when the name ends in .gz), and
:func:`reduce_trace` reads it: the device time of each span (the events
its host calls launched), the busy and idle time of the window and the
kernels that take the most. On the card the twin raises if the trace
holds no kernel events, if a span of the default path has no device time,
or if the buckets do not add up to the window within 1%.

It prints a line per piece (``piece``, ``ms``, ``tflops``, and on the card
``achieved_tflops_per_sec`` and ``mfu``), then the profile's line, each
with the device. A ``--device cpu`` run carries no device metric: its
profile line holds the spans' host ms only.

    python -m cosa_tpu_torch.cli.profile_step [--batch 4] [--iters 20] \\
        [--steps 5] [--out build/profile_step/trace.json.gz]
"""

from __future__ import annotations

import argparse
import bisect
import gzip
import json
import os
from collections import defaultdict
from typing import Dict, List

import torch
from torch.profiler import ProfilerActivity

from cosa_tpu_torch.cli.bench import (
    WARMUP,
    count_flops,
    device_info,
    emit,
    host_batch,
    plain_kernels,
    rates,
    sync,
    time_calls,
)
from cosa_tpu_torch.config import voc_config
from cosa_tpu_torch.ops.image import normalize
from cosa_tpu_torch.train.loop import to_device
from cosa_tpu_torch.train.state import create_train_state, use_gmm_aux
from cosa_tpu_torch.train.step import build_train_step
from cosa_tpu_torch.utils.device import resolve_device

# the step's spans (train/step.py, utils/trace.py), in the order it runs them
SPANS = ("teacher_tta", "gmm", "pseudo_labels", "student_forward", "losses", "energy",
         "backward", "optimizer", "ema")
# the trace's device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the hand-written kernels, by a part of their names (csrc/)
KERNEL_TAGS = (("attn_fwd_kernel", "K1"), ("attn_bwd", "K2"), ("rff_phi", "K3"))
TOP_KERNELS = 15
SUM_TOL = 0.01  # the buckets against the window


def _owned(intervals, n_owners: int) -> List[float]:
    """How long each owner's intervals cover the time line, where each
    moment covered by several owners goes to the lowest owner index:
    ``intervals`` are (start, end, owner) with owners 0..n_owners-1."""
    edges = sorted([(a, 1, o) for a, b, o in intervals if b > a]
                   + [(b, -1, o) for a, b, o in intervals if b > a])
    active = [0] * n_owners
    out = [0.0] * n_owners
    last = None
    for t, d, o in edges:
        if last is not None and t > last:
            top = next((i for i, c in enumerate(active) if c), None)
            if top is not None:
                out[top] += t - last
        active[o] += d
        last = t
    return out


def _tag(name: str):
    return next((tag for part, tag in KERNEL_TAGS if part in name), None)


def reduce_trace(trace: Dict, top: int = TOP_KERNELS) -> Dict:
    """A torch.profiler chrome trace -> where its steps' time went, in ms
    per step (the trace's ProfilerStep annotations; one step without them).

    * ``host_ms``: each span's host time (its ``user_annotation`` events);
    * the window: from the first step's start (else the first device event)
      to the last step's or device event's end; device events before the
      first step are left out;
    * ``busy_ms``: the union of the device intervals (``kernel``,
      ``gpu_memcpy``, ``gpu_memset``: what the device's streams ran);
      ``idle_ms`` the rest of the window,
      ``idle_share`` = 1 - busy / window;
    * ``device_ms``: per span, the busy time of the device events launched
      inside it: an event's ``correlation`` names the host's runtime call
      that launched it, and the span whose host interval holds that call
      owns it (spans nested in a span, such as the optimizer's own, count
      for it; where two spans' events overlap on the device, the span
      listed first in :data:`SPANS` owns the overlap); ``unattributed_ms``:
      busy time no span owns;
    * ``top_kernels``: kernels by device ms, the hand-written ones named
      K1/K2/K3, and ``kernel_share``: each one's device ms over busy.

    So the spans' device ms, ``unattributed_ms`` and ``idle_ms`` add up to
    ``window_ms``. A trace without device events gives ``steps`` and
    ``host_ms`` only."""
    ev = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    steps = [e for e in ev if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("ProfilerStep#")]
    n = max(len(steps), 1)
    spans = sorted((e["ts"], e["ts"] + e["dur"], SPANS.index(e["name"])) for e in ev
                   if e.get("cat") == "user_annotation" and e.get("name") in SPANS)
    host = [0.0] * len(SPANS)
    for a, b, i in spans:
        host[i] += b - a
    out: Dict = dict(steps=n, host_ms={k: v / 1e3 / n for k, v in zip(SPANS, host)})
    first = min((e["ts"] for e in steps), default=None)
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS and (first is None or e["ts"] >= first)]
    if not dev:
        return out
    launched = {e["args"]["correlation"]: e["ts"] for e in ev
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    starts = [a for a, _, _ in spans]

    def owner(e) -> int:
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                return spans[i][2]
        return len(SPANS)  # unattributed

    owned = _owned([(e["ts"], e["ts"] + e["dur"], owner(e)) for e in dev], len(SPANS) + 1)
    lo = min(e["ts"] for e in dev + steps)
    hi = max(e["ts"] + e["dur"] for e in dev + steps)
    busy_us = sum(owned)
    kernels = defaultdict(lambda: [0.0, 0])
    for e in dev:
        if e.get("cat") == "kernel":
            kernels[e["name"]][0] += e["dur"]
            kernels[e["name"]][1] += 1
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    share = defaultdict(float)
    for name, (us, _) in kernels.items():
        if _tag(name):
            share[_tag(name)] += us / busy_us
    window = hi - lo
    ms = lambda us: us / 1e3 / n  # noqa: E731
    out.update(
        window_ms=ms(window), busy_ms=ms(busy_us), idle_ms=ms(window - busy_us),
        idle_share=1.0 - busy_us / window, busy_share=busy_us / window,
        device_ms={k: ms(v) for k, v in zip(SPANS, owned)},
        unattributed_ms=ms(owned[-1]),
        n_kernel_events=sum(c for _, c in kernels.values()),
        top_kernels=[dict(name=name[:120], kernel=_tag(name), ms=ms(us), calls=c / n)
                     for name, (us, c) in ranked[:top]],
        kernel_share={tag: share[tag] for _, tag in KERNEL_TAGS})
    return out


def load_trace(path: str) -> Dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def default_spans(cfg) -> List[str]:
    """The spans a step of ``cfg`` runs (``gmm`` only with GMM on)."""
    gmm = cfg.usegmm or use_gmm_aux(cfg)
    return [s for s in SPANS if s != "gmm" or gmm]


def profile_spans(cfg, state, step, batch_np, dev: torch.device, steps: int, path: str) -> Dict:
    """Profile ``steps`` full steps (module docstring), write the trace to
    ``path`` and reduce it; on the card, check what the reduction needs."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sched = torch.profiler.schedule(wait=1, warmup=1, active=steps)
    with torch.profiler.profile(activities=acts, schedule=sched,
                                on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for i in range(2 + steps):
            step(state, to_device(batch_np, dev))
            if i in (1, 1 + steps):  # the end of the warm-up step and of the last one
                sync(dev)
            prof.step()
    red = reduce_trace(load_trace(path))
    if dev.type != "cuda":
        return red
    if not red.get("n_kernel_events"):
        raise RuntimeError(f"{path}: the profiler's trace holds no kernel events on the card; "
                           "time the spans with CUDA events instead")
    silent = [s for s in default_spans(cfg) if not red["device_ms"][s] > 0]
    if silent:
        raise RuntimeError(f"{path}: no device time under the spans {silent}")
    total = sum(red["device_ms"].values()) + red["unattributed_ms"] + red["idle_ms"]
    if abs(total - red["window_ms"]) > SUM_TOL * red["window_ms"]:
        raise RuntimeError(f"{path}: the buckets add up to {total} ms, the window is "
                           f"{red['window_ms']} ms")
    return red


def time_pieces(cfg, state, step, batch, dev: torch.device, iters: int,
                info: Dict) -> List[Dict]:
    """One line per piece (module docstring)."""
    p = step.pieces
    act = torch.bfloat16 if cfg.mixed_precision else torch.float32
    simg = normalize(batch["simg"])
    cls_label = batch["cls_label"].to(torch.float32)
    box = batch["img_box"]
    targets = p.pseudo_targets(state, p.teacher_tta(state, normalize(batch["wimg"], dtype=act)),
                               simg, cls_label, box)

    def student_grad():
        loss = p.student_loss(state, simg, cls_label, box, targets)
        p.backward(state, loss["total"])
        return loss["total"]

    runs = (("full", lambda: step(state, batch)),
            ("teacher_tta", lambda: p.teacher_tta(state, normalize(batch["wimg"], dtype=act))),
            ("student_grad", student_grad),
            ("update", lambda: p.update(state)))
    lines = []
    for name, fn in runs:
        for _ in range(WARMUP):
            fn()
        with plain_kernels(state.student, state.teacher):
            flops = count_flops(fn)
        dt, _ = time_calls(fn, iters, dev)
        r = rates(flops, dt, info)
        lines.append(emit(dict(piece=name, ms=dt * 1e3, tflops=r.pop("tflops_per_step"),
                               **r, **info)))
    return lines


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--steps", type=int, default=5, help="profiled full steps")
    ap.add_argument("--crop", type=int, default=None)
    ap.add_argument("--backbone", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one); cpu runs the plain versions")
    ap.add_argument("--out", default=os.path.join("build", "profile_step", "trace.json.gz"),
                    help="the chrome trace (gzipped when it ends in .gz)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    info = device_info(dev)
    over = {k: v for k, v in (("crop_size", args.crop), ("backbone", args.backbone)) if v}
    cfg = voc_config(batch_size=args.batch, energy_convention=1.0, **over)
    state = create_train_state(cfg, dev, args.batch)
    step = build_train_step(cfg)
    batch_np = host_batch(cfg, args.batch)
    lines = time_pieces(cfg, state, step, to_device(batch_np, dev), dev, args.iters, info)
    red = profile_spans(cfg, state, step, batch_np, dev, args.steps, args.out)
    lines.append(emit(dict(profile="full_step", batch=args.batch, crop=cfg.crop_size,
                           trace=args.out, **red, **info)))
    return lines


if __name__ == "__main__":
    main()
