#!/usr/bin/env python3
"""Drive the PyTorch port (cosa_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and no phase catches and goes on:
  1. name the card (torch, and nvidia-smi's name and power limit);
  2. build the CUDA kernels from cosa_tpu_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version at the main path's
     shapes, and time kernel, plain version and one PyTorch library call;
  4. train 6 steps of the default VOC configuration (ViT-B/16, crop 448,
     batch 4, bf16, RFF energy) on synthetic data through
     cosa_tpu_torch.train.loop.train, from a seeded random init (no weights
     exist on the machine), and count each kernel's launches;
  5. from one state and batch, one step with the kernels against one with
     flash_attention=False (the plain attention);
  6. print the kernels' JSON line, then the device JSON line last.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense), for the least-time bounds
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# phase 5's bound on the kernel path's qkv-weight gradients against the
# plain path's, in norm: about 4x the largest gap read on an H100 (1.3e-2,
# even over the 12 blocks), far under the O(1) gap of a wrong gradient
GRAD_REL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"phase 1 device: torch={torch.__version__} cuda={torch.version.cuda} "
        f"kind={kind} count={torch.cuda.device_count()} smi={smi}")
    return kind, smi


def phase_build():
    from cosa_tpu_torch.kernels import build

    secs = build.build()
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"phase 2 build: {secs:.1f} s for {sorted(build.SOURCES.values())}")


def _qkv(b, n, h, gen):
    import torch

    return torch.randn((b, n, 3 * h * 64), generator=gen, device="cuda").to(torch.bfloat16)


def _split(qkv, h):
    b, n, c3 = qkv.shape
    x = qkv.float().reshape(b, n, 3, h, 64)
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]


def phase_kernels():
    """Kernel vs plain at the main path's shapes; every check runs and
    prints before the phase fails on any. Returns the JSON rows.

    Bounds, those of the TPU kernel test: K1 max |kernel - plain f32| <
    5e-3, K2 relative error < 1e-2, K3 (bf16 store) < 3e-4 against float64.
    K3's f32 store is held to 1e-5: its phases (|p| < 256 here) carry at
    most 5 f32 roundings of 7.6e-6 each, times the scale 0.044, 1.7e-6."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from cosa_tpu_torch.kernels import flash, rff
    from cosa_tpu_torch.ops.bilateral import _rff_params

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h = 4, 12  # B*H = 48, the student's batch at batch 4
    scale = 64 ** -0.5
    rows = []
    failures = []

    # ---- K1 forward at the three TTA token counts, with and without masking
    k1 = {}
    for n in (197, 785, 1765):
        qkv = _qkv(b, n, h, gen)
        for nv in (None, n - 37):
            o, _ = flash.attn_fwd(qkv, h, scale, nv)
            q, k, v = _split(qkv, h)
            ref = flash.plain_attention(q, k, v, scale, nv).reshape(b, n, h * 64)
            torch.cuda.synchronize()
            err = float((o.float() - ref).abs().max())
            log(f"  K1 N={n} n_valid={nv}: max|kernel - plain f32| = {err:.3e}")
            if not err < 5e-3:
                failures.append(f"K1 N={n} n_valid={nv}: {err}")
            k1[(n, nv)] = err
        qb, kb, vb = (t.to(torch.bfloat16) for t in _split(qkv, h))
        ms = time_ms(lambda: flash.attn_fwd(qkv, h, scale))
        plain = time_ms(lambda: flash.plain_attention(qb, kb, vb, scale))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (qb, kb, vb))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        flops = 4.0 * b * h * n * n * 64
        nbytes = 4.0 * b * h * n * 64 * 2 + b * h * n * 4
        bms, by = bound_ms(nbytes, flops, PEAK_BF16)
        log(f"  K1 N={n} B*H={b * h}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms, bound {bms:.4f} ms ({by})")
        if n == 785:
            rows.append(dict(
                name="flash_fwd", route="cuda",
                source="cosa_tpu_torch/csrc/flash_attn.cu",
                replaces="cosa_tpu/kernels/flash.py:201",
                shape=f"B*H={b * h} N={n} D=64 bf16",
                max_abs_err=max(k1.values()), ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib,
            ))

    # ---- K2 backward vs plain f32 autograd on the same bf16 inputs
    k2_err = 0.0
    for n, nv in ((785, None), (197, 160)):
        qkv = _qkv(b, n, h, gen)
        dout = torch.randn((b, n, h * 64), generator=gen, device="cuda").to(torch.bfloat16)
        o, lse = flash.attn_fwd(qkv, h, scale, nv)
        dqkv = flash.attn_bwd(qkv, o, dout, lse, h, scale, nv).float()
        x = qkv.float().requires_grad_(True)
        q, k, v = _split(x, h)
        ref_o = flash.plain_attention(q, k, v, scale, nv).reshape(b, n, h * 64)
        (ref,) = torch.autograd.grad(ref_o, x, dout.float())
        torch.cuda.synchronize()
        for i, nm in enumerate(("dq", "dk", "dv")):
            a = dqkv.reshape(b, n, 3, -1)[:, :, i]
            r = ref.reshape(b, n, 3, -1)[:, :, i]
            rel = float((a - r).abs().max() / (r.abs().max() + 1e-9))
            log(f"  K2 N={n} n_valid={nv} {nm}: rel err {rel:.3e}")
            if not rel < 1e-2:
                failures.append(f"K2 N={n} {nm}: {rel}")
            k2_err = max(k2_err, float((a - r).abs().max()))
    n = 785
    qkv = _qkv(b, n, h, gen)
    dout = torch.randn((b, n, h * 64), generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = flash.attn_fwd(qkv, h, scale)
    ms = time_ms(lambda: flash.attn_bwd(qkv, o, dout, lse, h, scale))
    xb = qkv.detach().clone().requires_grad_(True)
    qb, kb, vb = (t.to(torch.bfloat16) for t in _split(xb, h))
    ref_o = flash.plain_attention(qb, kb, vb, scale)
    g4 = dout.reshape(b, n, h, 64)
    plain = time_ms(lambda: torch.autograd.grad(ref_o, xb, g4, retain_graph=True))
    qh, kh, vh = (t.detach().transpose(1, 2).contiguous() for t in (qb, kb, vb))
    fw = torch.ops.aten._scaled_dot_product_flash_attention(qh, kh, vh, 0.0, False, False, scale=scale)
    gh = dout.reshape(b, n, h, 64).transpose(1, 2).contiguous()
    lib = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        gh, qh, kh, vh, fw[0], fw[1], fw[2], fw[3], fw[4], fw[5], 0.0, False,
        fw[6], fw[7], scale=scale))
    flops = 10.0 * b * h * n * n * 64
    nbytes = 8.0 * b * h * n * 64 * 2 + b * h * n * 4
    bms, by = bound_ms(nbytes, flops, PEAK_BF16)
    log(f"  K2 N={n} B*H={b * h}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"sdpa-flash bwd {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    rows.append(dict(
        name="flash_bwd", route="cuda", source="cosa_tpu_torch/csrc/flash_attn.cu",
        replaces="cosa_tpu/kernels/flash.py:228", shape=f"B*H={b * h} N={n} D=64 bf16",
        max_abs_err=k2_err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib,
    ))

    # ---- K3 RFF phi at the energy shape, vs float64 numpy
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (4, 224, 224, 3)).astype(np.float32)
    ys, xs = np.mgrid[0:224, 0:224].astype(np.float32)
    feats = np.concatenate([
        np.broadcast_to((xs / 50.0)[None, ..., None], (4, 224, 224, 1)),
        np.broadcast_to((ys / 50.0)[None, ..., None], (4, 224, 224, 1)),
        img / 15.0], axis=-1).reshape(4, 224 * 224, 5).astype(np.float32)
    w_np, b_np = _rff_params(1024, 5, 0)
    f = torch.from_numpy(feats).cuda()
    w = torch.from_numpy(w_np).cuda()
    bb = torch.from_numpy(b_np).cuda()
    sc = math.sqrt(2.0 / 1024)
    phi = rff.rff_phi(f, w, bb, sc)
    phi32 = rff.rff_phi(f, w, bb, sc, torch.float32)
    torch.cuda.synchronize()
    err = err32 = 0.0
    for i in range(4):  # f64 reference one image at a time (1.6 GB each)
        ref = sc * np.cos(feats[i].astype(np.float64) @ w_np + b_np)
        err = max(err, float(np.abs(phi[i].float().cpu().numpy() - ref).max()))
        err32 = max(err32, float(np.abs(phi32[i].cpu().numpy() - ref).max()))
    log(f"  K3 (4, 50176, 5) -> 1024: max|kernel - f64| = {err:.3e} (bf16 store), "
        f"{err32:.3e} (f32 store)")
    if not err < 3e-4:
        failures.append(f"K3 bf16: {err}")
    if not err32 < 1e-5:
        failures.append(f"K3 f32: {err32}")
    ms = time_ms(lambda: rff.rff_phi(f, w, bb, sc))
    plain = time_ms(lambda: rff.plain_rff_phi(f, w, bb, sc))
    ms32 = time_ms(lambda: rff.rff_phi(f, w, bb, sc, torch.float32))
    rows_n = 4 * 224 * 224
    nbytes = rows_n * 5 * 4 + 6 * 1024 * 4 + rows_n * 1024 * 2
    bms, by = bound_ms(nbytes, 10.0 * rows_n * 1024, PEAK_F32)
    bms32, _ = bound_ms(nbytes + rows_n * 1024 * 2, 10.0 * rows_n * 1024, PEAK_F32)
    log(f"  K3: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by}); "
        f"f32 store {ms32:.4f} ms, bound {bms32:.4f} ms")
    rows.append(dict(
        name="rff_phi", route="cuda", source="cosa_tpu_torch/csrc/rff_phi.cu",
        replaces="cosa_tpu/kernels/rff.py:89", shape="(4, 50176, 5) f32 -> 1024 bf16",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=None,
    ))
    if failures:
        raise AssertionError("phase 3 kernel checks failed: " + "; ".join(failures))
    log("phase 3 ok: K1 max err < 5e-3 at N in (197, 785, 1765), masked and "
        "not; K2 dq/dk/dv rel err < 1e-2; K3 max err vs f64 < 3e-4 (bf16), "
        "< 1e-5 (f32)")
    return rows


def _main_cfg(**kw):
    from cosa_tpu_torch.config import preset_config

    base = dict(
        backbone="vit_base_patch16_224", crop_size=448, batch_size=4,
        mixed_precision=True, pretrained=False, max_iters=6, warmup_iters=2,
        lr_warmup_iters=2, log_iters=1, eval_iters=10 ** 9, finalval=False,
        work_dir=os.path.join(ROOT, "build", "chip_smoke"),
    )
    base.update(kw)
    return preset_config("synthetic", **base)


def _counts():
    from cosa_tpu_torch.kernels import flash, rff

    return {**flash.LAUNCHES, **rff.LAUNCHES}


def _reset_counts():
    from cosa_tpu_torch.kernels import flash, rff

    for d in (flash.LAUNCHES, rff.LAUNCHES):
        for k in d:
            d[k] = 0


def phase_main_path(smi: str):
    import torch

    from cosa_tpu_torch.train.loop import train

    cfg = _main_cfg(name="main")
    steps = cfg.max_iters
    _reset_counts()
    res = train(cfg, device="cuda")
    torch.cuda.synchronize()
    counts = _counts()
    recs = res["records"]
    log(f"phase 4 main path: {len(recs)} steps, launches {counts}")
    if len(recs) != steps:
        raise AssertionError(f"expected {steps} logged steps, got {len(recs)}")
    keys = ("overall_loss", "cls_loss", "cls_aux_loss", "seg_loss", "cam_loss", "reg_loss")
    for r in recs:
        if not all(math.isfinite(r[k]) for k in keys):
            raise AssertionError(f"non-finite loss at iter {r['iter']}: {r}")
        if r["iter"] > cfg.warmup_iters + 1 and not all(
                r[k] != 0.0 for k in ("seg_loss", "cam_loss", "reg_loss")):
            raise AssertionError(f"zero gated loss after warmup: {r}")
    # per step: 12 blocks x (3 teacher scales + 1 student) forwards, 12
    # student backwards, one RFF embedding; plus the 2 RFF probes of the
    # energy-convention calibration before the first step
    want = {"flash_fwd": 48 * steps, "flash_bwd": 12 * steps, "rff_phi": steps + 2}
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    times = [r["itertime"] for r in recs[1:]]
    med = statistics.median(times)
    log(f"phase 4 ok: sec/iter median over steps 2-{steps} = {med:.4f} s "
        f"({cfg.batch_size / med:.2f} img/s) on {smi}; losses finite; "
        f"last {json.dumps({k: recs[-1][k] for k in keys})}")
    return counts, res["energy_convention"]


def _student_qkv_grads(state, simg, detach):
    """The student's qkv-weight gradient in each block under one seeded
    cotangent on each of its outputs: a backward through K2 (or the plain
    attention) at the main path's shapes, with no pseudo labels in it."""
    import torch

    out = state.student(simg, detach=detach)
    gen = torch.Generator(device="cuda").manual_seed(5)
    loss = sum((out[k].float() * torch.randn(out[k].shape, generator=gen, device="cuda")).sum()
               for k in sorted(out) if out[k].requires_grad)
    qkv = [p for n, p in state.student.named_parameters() if n.endswith("attn.qkv.weight")]
    return [g.float() for g in torch.autograd.grad(loss, qkv)]


def phase_flash_vs_plain(convention: float):
    """From one state and batch, on the card, the kernels (K1/K2) against
    the plain attention (flash_attention=False). Held: (a) each block's
    student qkv-weight gradient under a fixed cotangent, in norm, within
    GRAD_REL of the plain path's; (b) one training step's losses within
    5e-3 relative (floor 1e-4 absolute), about 10x the largest gap read on
    an H100 (4.9e-4). The two paths round differently in bf16: the plain
    path stores its scores in bf16, the kernel keeps them in f32 and feeds
    bf16 probabilities to the PV product. A whole step's gradients are not
    held: the teachers' pseudo masks differ by the pixels that sit at a
    threshold, and those flips move the gradient by several percent."""
    import torch

    from cosa_tpu_torch.data.loader import build_train_loader
    from cosa_tpu_torch.ops.image import normalize
    from cosa_tpu_torch.train.state import create_train_state
    from cosa_tpu_torch.train.step import build_train_step

    kw = dict(warmup_iters=-1, energy_convention=convention, name="cmp")
    cfg_k = _main_cfg(flash_attention=True, **kw)
    cfg_p = _main_cfg(flash_attention=False, **kw)
    loader = build_train_loader(cfg_k, cfg_k.batch_size)
    try:
        batch = next(loader)
    finally:
        loader.close()
    out, grads = {}, {}
    for tag, cfg in (("kernel", cfg_k), ("plain", cfg_p)):
        state = create_train_state(cfg, "cuda")
        tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
        grads[tag] = _student_qkv_grads(state, normalize(tb["simg"]), cfg.detach)
        m = build_train_step(cfg)(state, tb)
        out[tag] = {k: float(m[k]) for k in (
            "overall_loss", "cls_loss", "cls_aux_loss", "seg_loss", "cam_loss", "reg_loss")}
        del state
    gaps = {k: abs(a - out["plain"][k]) / max(abs(out["plain"][k]), 1e-30)
            for k, a in out["kernel"].items()}
    grad_rel = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
                for a, b in zip(grads["kernel"], grads["plain"])]
    log(f"phase 5: qkv grad rel err in norm by block {[f'{g:.2e}' for g in grad_rel]}; "
        f"kernel step {json.dumps(out['kernel'])} vs plain step {json.dumps(out['plain'])}, "
        f"largest relative loss gap {max(gaps.values()):.3e}")
    if len(grad_rel) != 12:
        raise AssertionError(f"expected 12 qkv gradients, got {len(grad_rel)}")
    if not max(grad_rel) < GRAD_REL:
        raise AssertionError(f"phase 5 qkv grads: rel err {max(grad_rel)} >= {GRAD_REL}")
    for k, a in out["kernel"].items():
        b = out["plain"][k]
        if not abs(a - b) <= max(5e-3 * abs(b), 1e-4):
            raise AssertionError(f"phase 5 {k}: kernel {a} vs plain {b}")
    log(f"phase 5 ok: qkv grads within {GRAD_REL} in norm, losses within 5e-3 relative")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "cosa_tpu_torch")):
        print("chip_smoke: run from a checkout that holds cosa_tpu_torch/", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    kind, smi = phase_device()
    phase_build()
    rows = phase_kernels()
    counts, convention = phase_main_path(smi)
    for r in rows:
        r["launches"] = counts[r["name"]]
        r["ok"] = True
    phase_flash_vs_plain(convention)
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
