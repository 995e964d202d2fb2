"""Benchmark: the co-training step's throughput on one GPU.

The port's counterpart of the JAX repo's bench.py. It times the full
co-training step, train/step.py::build_train_step (teacher 3-scale x flip
TTA, pseudo labels, student forward and backward with the dense energy,
PolyWarmupAdamW, the EMA teacher), eager, on one fixed device batch of
random uint8 images, at the reference's training configurations:

  * VOC:  ViT-B/16, 448^2 crop, 21 classes, global batch 4 (the
    reference's 0.92 s/iter on 2x RTX 3090 => 4.35 img/s,
    assets/logs/voc_log.txt:88);
  * VOC with ``energy_filter="lattice"``: the port builds the lattice
    inside the step's energy span, so its build is in the timed step;
  * COCO: ViT-B/16, 448^2, 81 classes, global batch 8 (2.54 s/iter on 2x
    RTX 3090 => 3.14 img/s, assets/logs/coco_log.txt:85).

``energy_convention=1.0`` as the JAX script sets it: the regularizer's
scale does not change the work.

Timing: 3 warm-up steps (the first builds the kernels with nvcc), then
``--iters`` steps on the host clock, ended by one
``torch.cuda.synchronize()``.

FLOPs: XLA's ``cost_analysis()`` has no counterpart. One extra step is
counted by ``torch.utils.flop_counter.FlopCounterMode`` with the attention
and the RFF embedding on their plain PyTorch versions (``use_kernel`` off
in every attention, the plain phi): K1/K2/K3 run through ctypes, so the
counter would not see them. The plain versions compute the same function
on the same shapes. The counter counts matrix products and convolutions
(2 per multiply-add), so the softmax, the elementwise work and the lattice
are left out of ``tflops_per_step``.

Each line: ``metric``, ``value`` (img/s), ``unit``, ``vs_baseline`` against
the reference's 2x RTX 3090 number (``baseline`` names it),
``sec_per_iter``, ``global_batch``, ``n_devices``, ``backend``, ``device``
and ``power_limit`` (nvidia-smi's), ``warmup_s``, ``launches_per_step``
(K1, K2, K3: the wrappers' counters over the timed steps),
``tflops_per_step``, and on the card ``achieved_tflops_per_sec`` and
``mfu`` against the card's dense bf16 peak (:data:`PEAK_BF16_TFLOPS`; an
unknown card gets ``mfu_reason`` instead). A ``--device cpu`` line carries
no device metric. The VOC line is printed first and again last;
``--repeats N`` times the VOC step N times (a line each) and the last line
carries their quartiles. The lattice and COCO lines run only if the wall
budget (``--budget_s``) allows, else they print as skipped.

    python -m cosa_tpu_torch.cli.bench [--iters 20] [--repeats 3]
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from cosa_tpu_torch.config import coco_config, voc_config
from cosa_tpu_torch.kernels import flash, rff
from cosa_tpu_torch.ops import bilateral
from cosa_tpu_torch.train.state import create_train_state
from cosa_tpu_torch.train.step import build_train_step
from cosa_tpu_torch.utils.device import resolve_device

VOC_BASELINE_IMGS_PER_SEC = 4.35  # 2x RTX 3090, global batch 4, 0.92 s/iter
COCO_BASELINE_IMGS_PER_SEC = 3.14  # 2x RTX 3090, global batch 8, 2.54 s/iter
BASELINE = "reference, 2x RTX 3090"

# the optional lines' wall time as a multiple of the VOC line's
COCO_OVER_VOC = 1.5
LATTICE_OVER_VOC = 1.3

# dense bf16 peak per card, TFLOP/s (NVIDIA's data sheet, SXM part);
# matched as substrings of torch.cuda.get_device_name
PEAK_BF16_TFLOPS = (("H100 80GB HBM3", 989.0), ("H100 SXM", 989.0))

WARMUP = 3  # steps before a timed window; the first builds the kernels


def device_info(dev: torch.device) -> Dict:
    """The device a line was measured on: the card's name and nvidia-smi's
    power limit, or "cpu"."""
    if dev.type != "cuda":
        return dict(device="cpu", power_limit=None)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(dev.index or 0)],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        limit = f"not read ({e})"
    return dict(device=torch.cuda.get_device_name(dev), power_limit=limit)


def peak_tflops(device_name: str) -> Optional[float]:
    for sub, peak in PEAK_BF16_TFLOPS:
        if sub in device_name:
            return peak
    return None


def add_model_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--backbone", default=None,
                    help="override the backbone (vit_tiny_test for a CPU run)")
    ap.add_argument("--crop_size", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (raises without one); cpu runs the plain versions")


def model_overrides(args) -> Dict:
    return {k: getattr(args, k) for k in ("backbone", "crop_size")
            if getattr(args, k) is not None}


def host_batch(cfg, global_batch: int) -> Dict[str, np.ndarray]:
    """One batch of random uint8 images and labels on the host, as the JAX
    bench.py draws it."""
    rng = np.random.default_rng(0)
    s = cfg.crop_size
    return dict(
        wimg=rng.integers(0, 255, (global_batch, s, s, 3)).astype(np.uint8),
        simg=rng.integers(0, 255, (global_batch, s, s, 3)).astype(np.uint8),
        cls_label=(rng.random((global_batch, cfg.num_classes - 1)) > 0.8).astype(np.float32),
        img_box=np.tile(np.array([[0, s, 0, s]], np.int32), (global_batch, 1)),
    )


def random_batch(cfg, global_batch: int, dev: torch.device) -> Dict:
    """:func:`host_batch` on ``dev``."""
    return {k: torch.from_numpy(v).to(dev) for k, v in host_batch(cfg, global_batch).items()}


def launches() -> Dict[str, int]:
    """The K1, K2, K3 wrappers' launch counters as they stand."""
    return {**flash.LAUNCHES, **rff.LAUNCHES}


@contextmanager
def plain_kernels(*modules: torch.nn.Module):
    """Every attention of ``modules`` and the RFF embedding on their plain
    PyTorch versions, for the FLOP counter."""
    attn = [m for mod in modules for m in mod.modules()
            if isinstance(getattr(m, "use_kernel", None), bool)]
    saved = [m.use_kernel for m in attn]
    phi = bilateral.rff_phi
    try:
        for m in attn:
            m.use_kernel = False
        bilateral.rff_phi = rff.plain_rff_phi
        yield
    finally:
        for m, v in zip(attn, saved):
            m.use_kernel = v
        bilateral.rff_phi = phi


def bmm_flops(a_shape, b_shape, *_, out_shape=None, **kwargs) -> int:
    """2 b m n k for ``bmm``, its ``out_dtype`` overload included: that one
    (the RFF filter's bf16 product into f32 on the card) passes the dtype
    third, where the counter's own formula takes the output's shape."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[2]


def count_flops(fn: Callable) -> int:
    """The FLOPs of one call of ``fn`` (matrix products and convolutions,
    forward and backward), by FlopCounterMode."""
    with FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: bmm_flops}) as counter:
        fn()
    return int(counter.get_total_flops())


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_calls(fn: Callable, iters: int, dev: torch.device) -> Tuple[float, object]:
    """Seconds per call of ``fn`` over ``iters`` calls on the host clock,
    ended by one synchronize, and the last call's result."""
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    sync(dev)
    return (time.perf_counter() - t0) / iters, out


def bench_step(cfg, global_batch: int, dev: torch.device, iters: int,
               repeats: int = 1) -> Dict:
    """Time ``cfg``'s step on one fixed batch: WARMUP steps, then
    ``repeats`` windows of ``iters`` steps. Returns each window's sec/iter,
    the set-up and warm-up seconds, the FLOPs of one step and the kernels'
    launches per timed step."""
    t0 = time.perf_counter()
    state = create_train_state(cfg, dev, global_batch)
    step = build_train_step(cfg)
    batch = random_batch(cfg, global_batch, dev)
    for _ in range(WARMUP):
        step(state, batch)
    sync(dev)
    warmup_s = time.perf_counter() - t0
    with plain_kernels(state.student, state.teacher):
        flops = count_flops(lambda: step(state, batch))
    secs = []
    before = launches()
    for _ in range(repeats):
        dt, metrics = time_calls(lambda: step(state, batch), iters, dev)
        loss = float(metrics["overall_loss"])
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss} in the timed steps")
        secs.append(dt)
    after = launches()
    counts = {k: after[k] - before[k] for k in after}
    return dict(secs=secs, warmup_s=warmup_s, flops=flops,
                launches_per_step={k: v / (iters * repeats) for k, v in counts.items()})


def rates(flops: float, sec: float, info: Dict) -> Dict:
    """tflops_per_step, and on the card the achieved rate and the MFU."""
    out = dict(tflops_per_step=flops / 1e12)
    if info["device"] == "cpu":
        return out
    out["achieved_tflops_per_sec"] = flops / 1e12 / sec
    peak = peak_tflops(info["device"])
    if peak is None:
        out["mfu_reason"] = f"no dense bf16 peak known for {info['device']}"
    else:
        out["mfu"] = out["achieved_tflops_per_sec"] / peak
        out["peak_bf16_tflops"] = peak
    return out


def step_line(metric: str, res: Dict, sec: float, global_batch: int, dev: torch.device,
              info: Dict, baseline: float) -> Dict:
    line = dict(metric=metric, value=global_batch / sec, unit="img/s",
                vs_baseline=global_batch / sec / baseline,
                baseline=f"{BASELINE}: {baseline} img/s")
    line.update(sec_per_iter=sec, global_batch=global_batch, n_devices=1,
                backend=dev.type, **info, warmup_s=res["warmup_s"],
                launches_per_step=res["launches_per_step"], **rates(res["flops"], sec, info))
    return line


def emit(line: Dict) -> Dict:
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--budget_s", type=float, default=520.0)
    add_model_args(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    info = device_info(dev)
    over = model_overrides(args)
    t_start = time.perf_counter()
    lines = []

    def run(name, make_cfg, global_batch, baseline, iters, repeats=1, **kw):
        cfg = make_cfg(batch_size=global_batch, energy_convention=1.0, **over, **kw)
        res = bench_step(cfg, global_batch, dev, iters, repeats)
        return res, [step_line(f"{name}_train_imgs_per_sec", res, s, global_batch, dev, info,
                               baseline) for s in res["secs"]]

    voc, voc_lines = run("voc", voc_config, 4, VOC_BASELINE_IMGS_PER_SEC, args.iters,
                         args.repeats)
    for i, line in enumerate(voc_lines):  # the headline out early
        lines.append(emit(dict(line, repeat=i) if args.repeats > 1 else line))
    voc_elapsed = time.perf_counter() - t_start

    def gate(metric, factor, thunk):
        remaining = args.budget_s - (time.perf_counter() - t_start)
        if remaining > factor * voc_elapsed + 20:
            lines.append(emit(thunk()[1][0]))
        else:
            lines.append(emit(dict(metric=metric, skipped=True, reason=(
                f"budget: {remaining:.0f} s left of {args.budget_s:.0f} s, the VOC line "
                f"took {voc_elapsed:.0f} s"), **info)))

    gate("voc_lattice_train_imgs_per_sec", LATTICE_OVER_VOC,
         lambda: run("voc_lattice", voc_config, 4, VOC_BASELINE_IMGS_PER_SEC, args.iters,
                     energy_filter="lattice"))
    gate("coco_train_imgs_per_sec", COCO_OVER_VOC,
         lambda: run("coco", coco_config, 8, COCO_BASELINE_IMGS_PER_SEC, args.iters))

    # the headline again, last: the median window's line, with the quartiles
    secs = voc["secs"]
    med = statistics.median(secs)
    head = step_line("voc_train_imgs_per_sec", voc, med, 4, dev, info, VOC_BASELINE_IMGS_PER_SEC)
    if args.repeats > 1:
        head.update(repeats=len(secs), iters_per_repeat=args.iters,
                    sec_per_iter_repeats=secs,
                    sec_per_iter_quartiles=statistics.quantiles(secs, n=4, method="inclusive"))
    lines.append(emit(head))
    return lines


if __name__ == "__main__":
    main()
