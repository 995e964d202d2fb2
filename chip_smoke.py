#!/usr/bin/env python3
"""Drive the PyTorch port (cosa_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and no phase catches and goes on:
  1. name the card (torch, and nvidia-smi's name and power limit);
  2. build the CUDA kernels from cosa_tpu_torch/csrc with nvcc, and read
     the built SASS: K1/K2 and K4 (K1's forward with another softmax) must
     issue wgmma and async copies, K4's bf16exp mode a bf16 exp2, and K3
     no slow-path cosine (MUFU.COS/SIN, local memory, a call);
  3. hold each kernel against its plain PyTorch version at the shapes its
     paths give it (K1 also at the evaluation's token counts, K4 at the
     softmax microbenchmark's), and time kernel, plain version and one
     PyTorch library call as device time, by replaying a CUDA graph (K1 at
     both block sizes and every (B*H, N) the paths launch it with, summed
     per training step and per eval batch; K4 beside K1 at the same shape
     and block size; K3 beside a fill of its output);
  4. train 6 steps of the default VOC configuration (ViT-B/16, crop 448,
     batch 4, bf16, RFF energy) on synthetic data through
     cosa_tpu_torch.train.loop.train, from a seeded random init (no weights
     exist on the machine), and count each kernel's launches;
  5. from one state and batch, one step with the kernels against one with
     flash_attention=False (the plain attention) and one with the
     attention in float64;
  6. the scoring path at the same width: 4 training steps with a
     validation of student and teacher and a checkpoint every 2, the final
     evaluation of the best-seg weights on the 256-image val split with the
     device DenseCRF (5 scales, eval_batch 8), and a run resumed from the
     step-2 checkpoint held to the straight run's losses; exact launch
     counts for each of the three;
  7. the softmax microbenchmark (cli/microbench_softmax.py), K4's path;
  8. print the kernels' JSON line, then the device JSON line last.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense), for the least-time bounds
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# phase 5's bound on the kernel path's qkv-weight gradients against the
# plain path's, in norm: about 4x the largest gap read on an H100 (1.3e-2,
# even over the 12 blocks), far under the O(1) gap of a wrong gradient
GRAD_REL = 5e-2
# phase 5's bound on the kernel step's pseudo-mask pixels that differ from
# the float64 attention's step, as a multiple of the plain attention's:
# the plain path's flips count the pixels that sit at a threshold, which
# any bf16 rounding moves; a kernel that rounds worse flips more
FLIP_RATIO = 1.5


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int = 20, warmup: int = 3, graph: bool = True) -> float:
    """Device ms per call of ``fn``, by CUDA events. With ``graph``, the
    ``reps`` calls are captured in one CUDA graph and replayed, so the
    host's cost of a launch (a wrapper's Python, the dispatcher) does not
    enter the time: at N = 197 it is as long as the kernels themselves."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        g.replay()
    else:
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

    import re

    secs = build.build()
    for name, text in build.BUILD_LOG.items():
        fn = name
        for line in text.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = _kernel_name(m.group(1)) or m.group(1)
            if "registers" in line or "spill" in line:
                log(f"  ptxas {fn}: {line.strip()}")
    log(f"phase 2 build: {secs:.1f} s for {sorted(build.SOURCES.values())}")
    ops = _sass(build, "flash")
    for fn, c in ops.items():
        log(f"phase 2 sass: {fn} {json.dumps({k: c.get(k, 0) for k in FLASH_OPS})}")
    # every forward build (K1 and K4's modes, both block sizes) must multiply
    # on wgmma and load by TMA or cp.async; the backward's product kernel
    # must hold ldmatrix or wgmma, and an async copy. The backward's pre- and
    # post-kernels (delta and dq's scratch, dq's bf16 store) are elementwise
    # passes with no product and no tile ring.
    bad = []
    for fn, c in ops.items():
        if not fn.startswith(("attn_fwd_kernel", "attn_bwd_kernel")):
            continue
        mm = c.get("HGMMA", 0) + (0 if fn.startswith("attn_fwd") else c.get("LDSM", 0))
        if not (mm and c.get("UTMALDG", 0) + c.get("LDGSTS", 0)):
            bad.append(fn)
    fwd = {f"attn_fwd_kernel<{r},{m}>" for r in BLOCKS for m in FWD_MODES}
    if bad or not fwd | {"attn_bwd_kernel"} <= set(ops):
        raise AssertionError(f"phase 2: flash kernels without wgmma/async copies: {bad}, "
                             f"found {sorted(ops)}")
    mufu = {fn: {k: v for k, v in c.items() if k.startswith("MUFU")}
            for fn, c in ops.items() if fn.startswith("attn_fwd_kernel")}
    log(f"phase 2 sass: the forward's MUFU instructions by build {json.dumps(mufu)}")
    if not all(mufu[f"attn_fwd_kernel<{r},bf16exp>"].get("MUFU.EX2.BF16") for r in BLOCKS):
        raise AssertionError("phase 2: a bf16exp build has no bf16 MUFU.EX2")
    # K3: the polynomial cosine, so no MUFU.COS/SIN (__cosf) and none of the
    # accurate cosf's slow path (local memory, a call)
    k3 = _sass(build, "rff")
    for fn, c in k3.items():
        log(f"phase 2 sass: {fn} {c['instructions']} instructions, {c['loop']} in the row "
            f"loop ({c['loop'] / K3_LOOP_OUTPUTS:.2f} per output), "
            f"{json.dumps({k: c.get(k, 0) for k in K3_OPS})}")
    slow = {fn: [k for k in c if k.startswith(K3_BANNED) or k.split(".")[0] in K3_BANNED]
            for fn, c in k3.items()}
    slow = {fn: ks for fn, ks in slow.items() if ks}
    if slow or len(k3) != 2:
        raise AssertionError(f"phase 2: K3 builds {sorted(k3)}, slow-path cosine in {slow}")
    log("phase 2 ok: every forward (K1, K4) and K2 product kernel issues HGMMA and "
        "LDGSTS/UTMALDG, bf16exp issues MUFU.EX2.BF16, K3 has no MUFU.COS/SIN, LDL, STL "
        "or CALL")


FWD_MODES = ("exact", "bf16exp", "nomax")  # attn_fwd_kernel's MODE 0, 1, 2
FLASH_OPS = ("HGMMA", "LDSM", "UTMALDG", "LDGSTS")
K3_OPS = ("FFMA", "FMUL", "FRND", "F2FP", "LDG", "STG")
K3_BANNED = ("MUFU.COS", "MUFU.SIN", "LDL", "STL", "CALL")
K3_LOOP_OUTPUTS = 16  # one pass of K3's row loop: 2 rows of 8 features a thread


def _kernel_name(sym: str):
    """A readable name of one of the port's kernels from its mangled symbol:
    attn_fwd_kernel<queries per block,mode>, rff_phi_kernel<store>."""
    import re

    m = re.search(r"\d((?:attn_[a-z_]+?|rff_phi)_kernel)"
                  r"(?:I((?:Li\d+E|13__nv_bfloat16|f)+)E)?", sym)
    if not m:
        return None
    args = []
    for nwg, bf, f32 in re.findall(r"Li(\d+)E|(13__nv_bfloat16)|(f)", m.group(2) or ""):
        if nwg:
            args.append(str(64 * int(nwg)) if not args else FWD_MODES[int(nwg)])
        else:
            args.append("bf16" if bf else "f32")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def _sass(build, lib: str):
    """{kernel of one built library: {opcode: count}} by cuobjdump (beside
    nvcc), counted both whole (MUFU.EX2.BF16) and by base name (HGMMA),
    with the kernel's instruction count and the length of its longest loop
    (a branch back to an earlier address)."""
    import re

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build._lib_path(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = _kernel_name(m.group(1))
            if fn:
                out[fn] = {"instructions": 0, "loop": 0}
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if not (m and fn):
            continue
        addr, op, rest = int(m.group(1), 16), m.group(2), m.group(3)
        c = out[fn]
        if op != "NOP":
            c["instructions"] += 1
        for k in {op, op.split(".")[0]}:
            c[k] = c.get(k, 0) + 1
        t = re.match(r"\s+(0x[0-9a-f]+)", rest)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            c["loop"] = max(c["loop"], (addr - int(t.group(1), 16)) // 16 + 1)
    return out


BLOCKS = (64, 128)  # queries per block that K1 takes


@contextmanager
def _k1_block(flash, rows: int):
    """K1's launcher takes ``rows`` queries per block at every N."""
    saved = flash.BLOCK_128_ABOVE
    flash.BLOCK_128_ABOVE = -1 if rows == 128 else 1 << 30
    try:
        yield
    finally:
        flash.BLOCK_128_ABOVE = saved

# (B*H, N, caller) of every K1 launch on the paths, 12 blocks each
K1_SHAPES = (
    (96, 785, "teacher"), (96, 197, "teacher"), (96, 1765, "teacher"),
    (48, 785, "student"),
    (192, 197, "eval"), (192, 442, "eval"), (192, 785, "eval"), (192, 1226, "eval"),
    (192, 1765, "eval"),
)


def _qkv(b, n, h, gen):
    import torch

    return torch.randn((b, n, 3 * h * 64), generator=gen, device="cuda").to(torch.bfloat16)


def _split(qkv, h):
    b, n, c3 = qkv.shape
    x = qkv.float().reshape(b, n, 3, h, 64)
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]


def _cosine(a, b) -> float:
    import torch

    a, b = a.float().reshape(-1), b.float().reshape(-1)
    return float(torch.dot(a, b) / (torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)))


def phase_kernels():
    """Kernel vs plain at the main path's shapes; every check runs and
    prints before the phase fails on any. Returns the JSON rows.

    Bounds, those of the TPU kernel test: K1 max |kernel - plain f32| <
    5e-3, K2 relative error < 1e-2, K3 (bf16 store) < 3e-4 against float64.
    K3's f32 store is held to 1e-5: its phases (|p| < 256 here) carry at
    most 5 f32 roundings of 7.6e-6 each, and its polynomial cosine up to
    1.4e-5, times the scale 0.044, 2.3e-6.
    K4 max |kernel - plain f32| <= 1e-2 (its p is bf16, as the plain
    version's, but rounded at other points), cosine >= 0.9999 against K1's
    output on the same input."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from cosa_tpu_torch.kernels import flash, flash_variants, rff
    from cosa_tpu_torch.ops.bilateral import _rff_params

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h = 4, 12  # B*H = 48, the student's batch at batch 4
    scale = 64 ** -0.5
    rows = []
    failures = []

    # ---- K1 forward, with and without masking, at the training TTA's token
    # counts (B*H = 48) and at the evaluation's 0.75 and 1.25 scales of crop
    # 448 (eval_batch 8 and its flips: B*H = 192), whose key tiles end ragged
    k1 = {}
    for bk, n in ((b, 197), (b, 785), (b, 1765), (16, 442), (16, 1226)):
        qkv = _qkv(bk, n, h, gen)
        for nv in (None, n - 37):
            q, k, v = _split(qkv, h)
            ref = flash.plain_attention(q, k, v, scale, nv).reshape(bk, n, h * 64)
            for rows_ in BLOCKS:
                with _k1_block(flash, rows_):
                    o, _ = flash.attn_fwd(qkv, h, scale, nv)
                torch.cuda.synchronize()
                err = float((o.float() - ref).abs().max())
                log(f"  K1 N={n} B*H={bk * h} n_valid={nv} {rows_} queries per block: "
                    f"max|kernel - plain f32| = {err:.3e}")
                if not err < 5e-3:
                    failures.append(f"K1 N={n} n_valid={nv} block {rows_}: {err}")
                k1[(n, nv, rows_)] = err

    # ---- K1 times at every (B*H, N) the paths launch it with, 12 blocks
    # each: the teacher's TTA scales 1.0 / 0.5 / 1.5 (batch 4 and its flips)
    # and the student's per training step, the evaluation's five scales
    # (eval_batch 8 and its flips) per eval batch. Each shape is timed at
    # both block sizes: the launcher's rule (kernels/flash.py::block_rows)
    # is meant to take the faster, and the derived line names any shape
    # where it did not
    sums = {w: [0.0, 0.0] for w in ("step", "eval")}  # kernel, sdpa ms
    slower = []  # shapes where the rule's block size read slower
    for bh, n, where in K1_SHAPES:
        bk = bh // h
        qkv = _qkv(bk, n, h, gen)
        qb, kb, vb = (t.to(torch.bfloat16) for t in _split(qkv, h))
        by_rows = {}
        for r in BLOCKS:
            with _k1_block(flash, r):
                by_rows[r] = time_ms(lambda: flash.attn_fwd(qkv, h, scale))
        rule = flash.block_rows(n)
        ms = by_rows[rule]
        if by_rows[rule] > min(by_rows.values()):
            slower.append(f"({bh}, {n})")
        plain = time_ms(lambda: flash.plain_attention(qb, kb, vb, scale))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (qb, kb, vb))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        flops = 4.0 * bk * h * n * n * 64
        nbytes = 4.0 * bk * h * n * 64 * 2 + bk * h * n * 4
        bms, by = bound_ms(nbytes, flops, PEAK_BF16)
        log(f"  K1 N={n} B*H={bh} ({where}): kernel {ms:.4f} ms at the rule's {rule} "
            f"queries per block (64: {by_rows[64]:.4f}, 128: {by_rows[128]:.4f}), plain "
            f"{plain:.4f} ms, sdpa {lib:.4f} ms ({ms / lib:.2f}x), bound {bms:.4f} ms ({by})")
        tot = sums["eval" if where == "eval" else "step"]
        tot[0] += 12 * ms
        tot[1] += 12 * lib
        if where == "student":
            rows.append(dict(
                name="flash_fwd", route="cuda",
                source="cosa_tpu_torch/csrc/flash_attn.cu",
                replaces="cosa_tpu/kernels/flash.py:201",
                shape=f"B*H={bh} N={n} D=64 bf16",
                max_abs_err=max(k1.values()), ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib,
            ))
    log(f"  K1 derived: {sums['step'][0]:.3f} ms per training step (sdpa "
        f"{sums['step'][1]:.3f}), {sums['eval'][0]:.3f} ms per eval batch (sdpa "
        f"{sums['eval'][1]:.3f}); the rule's block size read slower than the other "
        f"at {', '.join(slower) or 'no shape'}")

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
    # eager: autograd's backward runs on the forward's stream, outside a capture
    plain = time_ms(lambda: torch.autograd.grad(ref_o, xb, g4, retain_graph=True),
                    graph=False)
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
        f"sdpa-flash bwd {lib:.4f} ms ({ms / lib:.2f}x), bound {bms:.4f} ms ({by}); derived "
        f"{12 * ms:.3f} ms per training step (library {12 * lib:.3f})")
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
    rows_n = 4 * 224 * 224
    nbytes = rows_n * 5 * 4 + 6 * 1024 * 4 + rows_n * 1024 * 2
    bms, by = bound_ms(nbytes, 10.0 * rows_n * 1024, PEAK_F32)
    bms32, by32 = bound_ms(nbytes + rows_n * 1024 * 2, 10.0 * rows_n * 1024, PEAK_F32)
    ms = time_ms(lambda: rff.rff_phi(f, w, bb, sc))
    ms32 = time_ms(lambda: rff.rff_phi(f, w, bb, sc, torch.float32))
    plain = time_ms(lambda: rff.plain_rff_phi(f, w, bb, sc))
    plain32 = time_ms(lambda: rff.plain_rff_phi(f, w, bb, sc, torch.float32))
    for dt, t, bd, pl in ((torch.bfloat16, ms, bms, plain), (torch.float32, ms32, bms32, plain32)):
        nm = "bf16" if dt == torch.bfloat16 else "f32"
        # the card's own write rate: one fill of an output of the same size
        full = torch.empty((4, 224 * 224, 1024), dtype=dt, device="cuda")
        fill = time_ms(lambda: full.fill_(0.5))
        del full
        log(f"  K3 {nm} store: kernel {t:.4f} ms (one launch per training step), "
            f"bound {bd:.4f} ms ({by if dt == torch.bfloat16 else by32}), "
            f"{bd / t:.3f} of the bound; a fill of the same output (fill_) {fill:.4f} ms; "
            f"plain {pl:.4f} ms")
    rows.append(dict(
        name="rff_phi", route="cuda", source="cosa_tpu_torch/csrc/rff_phi.cu",
        replaces="cosa_tpu/kernels/rff.py:89", shape="(4, 50176, 5) f32 -> 1024 bf16",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=None,
    ))

    # ---- K4, the two softmax variants, at the microbenchmark's B*H = 96,
    # each beside K1 at the same shape and block size
    bv = 8
    k4 = {m: [0.0, 1.0] for m in flash_variants.MODES}  # worst err, worst cos
    for n in (785, 1765):
        qkv = _qkv(bv, n, h, gen)
        x = qkv.reshape(bv, n, 3, h, 64).permute(2, 0, 3, 1, 4).reshape(3, bv * h, n, 64)
        for nv in (None, n - 37):
            o1 = flash.attn_fwd(qkv, h, scale, nv)[0]
            for mode in flash_variants.MODES:
                o = flash_variants.attn_fwd_variant(qkv, h, scale, nv, mode)
                ref = flash_variants.plain_attend_variant(x[0], x[1], x[2], scale, nv, mode)
                ref = ref.reshape(bv, h, n, 64).permute(0, 2, 1, 3).reshape(bv, n, h * 64)
                torch.cuda.synchronize()
                err = float((o.float() - ref).abs().max())
                cos = _cosine(o, o1)
                log(f"  K4 {mode} N={n} n_valid={nv}: max|kernel - plain f32| = {err:.3e}, "
                    f"cos vs K1 = {cos:.7f}")
                if not (err <= 1e-2 and cos >= 0.9999):
                    failures.append(f"K4 {mode} N={n} n_valid={nv}: err {err} cos {cos}")
                k4[mode] = [max(k4[mode][0], err), min(k4[mode][1], cos)]
        qh, kh, vh = (t.reshape(bv, h, n, 64) for t in x)
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        bms, by = bound_ms(4.0 * bv * h * n * 64 * 2, 4.0 * bv * h * n * n * 64, PEAK_BF16)
        # in turns: K1, bf16exp, nomax, nomax, bf16exp, K1
        turns = ("k1", *flash_variants.MODES, *reversed(flash_variants.MODES), "k1")
        ms_by = {}
        for mode in turns:
            fn = (lambda: flash.attn_fwd(qkv, h, scale)) if mode == "k1" else (
                lambda m=mode: flash_variants.attn_fwd_variant(qkv, h, scale, None, m))
            ms_by.setdefault(mode, []).append(time_ms(fn))
        ms_by = {m: statistics.mean(v) for m, v in ms_by.items()}
        for mode in flash_variants.MODES:
            ms = ms_by[mode]
            plain = time_ms(lambda: flash_variants.plain_attend_variant(
                x[0], x[1], x[2], scale, None, mode))
            log(f"  K4 {mode} N={n} B*H={bv * h}: kernel {ms:.4f} ms, K1 {ms_by['k1']:.4f} ms "
                f"at the same {flash.block_rows(n)} queries per block ({ms / ms_by['k1']:.3f}x "
                f"K1), plain {plain:.4f} ms, sdpa {lib:.4f} ms ({ms / lib:.2f}x), "
                f"bound {bms:.4f} ms ({by})")
            if n == 785:
                rows.append(dict(
                    name=f"flash_fwd_{mode}", route="cuda",
                    source="cosa_tpu_torch/csrc/flash_attn.cu",
                    replaces="scripts/microbench_softmax.py:79",
                    shape=f"B*H={bv * h} N={n} D=64 bf16",
                    max_abs_err=k4[mode][0], ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib,
                ))
    if failures:
        raise AssertionError("phase 3 kernel checks failed: " + "; ".join(failures))
    log("phase 3 ok: K1 max err < 5e-3 at N in (197, 442, 785, 1226, 1765), "
        "masked and not; K2 dq/dk/dv rel err < 1e-2; K3 max err vs f64 < 3e-4 "
        "(bf16), < 1e-5 (f32); K4 max err <= 1e-2 and cos vs K1 >= 0.9999 "
        f"({json.dumps(k4)})")
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


def _launch_dicts():
    from cosa_tpu_torch.kernels import flash, flash_variants, rff

    return flash.LAUNCHES, rff.LAUNCHES, flash_variants.LAUNCHES


def _counts():
    return {k: v for d in _launch_dicts() for k, v in d.items()}


def _reset_counts():
    for d in _launch_dicts():
        for k in d:
            d[k] = 0


def _want(**nonzero):
    """Every kernel's expected launch count: ``nonzero``, else 0."""
    return {k: nonzero.get(k, 0) for k in _counts()}


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
    want = _want(flash_fwd=48 * steps, flash_bwd=12 * steps, rff_phi=steps + 2)
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


def _attention_f64(qkv, num_heads, scale, use_kernel, n_valid=None):
    """The ViT's attention (models/vit.py) in float64 throughout, cast back
    to qkv's dtype: phase 5's reference for both bf16 paths."""
    import torch

    b, n, c3 = qkv.shape
    x = qkv.double().reshape(b, n, 3, num_heads, c3 // (3 * num_heads))
    s = torch.einsum("bqhd,bkhd->bhqk", x[:, :, 0] * scale, x[:, :, 1])
    if n_valid is not None and n_valid < n:
        s = s.masked_fill(torch.arange(n, device=s.device) >= n_valid, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), x[:, :, 2])
    return o.reshape(b, n, c3 // 3).to(qkv.dtype)


def _recording(fn, into: list):
    """``fn``, appending each result to ``into``."""
    def rec(*args, **kw):
        into.append(fn(*args, **kw))
        return into[-1]
    return rec


def phase_flash_vs_plain(convention: float):
    """From one state and batch, on the card, the kernels (K1/K2) against
    the plain attention (flash_attention=False) and against the attention
    in float64. Held: (a) each block's student qkv-weight gradient under a
    fixed cotangent, in norm, within GRAD_REL of the plain path's; (b) one
    training step's losses within 5e-3 relative (floor 1e-4 absolute) of
    the plain path's, and of the float64 path's; (c) the teacher's pseudo
    masks of the kernel step differ from the float64 step's in at most
    FLIP_RATIO times as many pixels as the plain step's do. The two bf16
    paths round differently: the plain path stores its scores in bf16, the
    kernel keeps them in f32 and feeds bf16 probabilities to the PV
    product. A whole step's gradients are not held: the pseudo masks
    (cam2mask's thresholds on a random-init teacher's CAMs) flip the pixels
    that sit at a threshold under any change of rounding, and those flips
    move the gradient by several percent; (c) holds the kernel's share of
    such flips to the plain attention's."""
    import torch

    import cosa_tpu_torch.models.vit as vit
    import cosa_tpu_torch.train.step as step_mod
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
    out, grads, masks = {}, {}, {}
    cam2mask, attention = step_mod.cam2mask, vit.attention
    try:
        for tag, cfg in (("kernel", cfg_k), ("plain", cfg_p), ("f64", cfg_p)):
            masks[tag] = []
            step_mod.cam2mask = _recording(cam2mask, masks[tag])
            vit.attention = _attention_f64 if tag == "f64" else attention
            state = create_train_state(cfg, "cuda")
            tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
            if tag != "f64":
                grads[tag] = _student_qkv_grads(state, normalize(tb["simg"]), cfg.detach)
            m = build_train_step(cfg)(state, tb)
            out[tag] = {k: float(m[k]) for k in (
                "overall_loss", "cls_loss", "cls_aux_loss", "seg_loss", "cam_loss", "reg_loss")}
            del state
    finally:
        step_mod.cam2mask, vit.attention = cam2mask, attention
    gaps = {k: abs(a - out["plain"][k]) / max(abs(out["plain"][k]), 1e-30)
            for k, a in out["kernel"].items()}
    gap64 = {tag: max(abs(a - out["f64"][k]) / max(abs(out["f64"][k]), 1e-30)
                      for k, a in out[tag].items()) for tag in ("kernel", "plain")}
    flips = {tag: int(sum(int((a != b).sum()) for a, b in zip(masks[tag], masks["f64"])))
             for tag in ("kernel", "plain")}
    pixels = sum(m.numel() for m in masks["f64"])
    grad_rel = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
                for a, b in zip(grads["kernel"], grads["plain"])]
    log(f"phase 5: qkv grad rel err in norm by block {[f'{g:.2e}' for g in grad_rel]}; "
        f"kernel step {json.dumps(out['kernel'])} vs plain step {json.dumps(out['plain'])}, "
        f"largest relative loss gap {max(gaps.values()):.3e}")
    log(f"phase 5 against the float64 attention: f64 step {json.dumps(out['f64'])}; largest "
        f"relative loss gap kernel {gap64['kernel']:.3e}, plain {gap64['plain']:.3e}; pseudo-mask "
        f"pixels that differ from the f64 step's: kernel {flips['kernel']}, plain "
        f"{flips['plain']} of {pixels}")
    if len(grad_rel) != 12:
        raise AssertionError(f"expected 12 qkv gradients, got {len(grad_rel)}")
    if not max(grad_rel) < GRAD_REL:
        raise AssertionError(f"phase 5 qkv grads: rel err {max(grad_rel)} >= {GRAD_REL}")
    for k, a in out["kernel"].items():
        b = out["plain"][k]
        if not abs(a - b) <= max(5e-3 * abs(b), 1e-4):
            raise AssertionError(f"phase 5 {k}: kernel {a} vs plain {b}")
        b = out["f64"][k]
        if not abs(a - b) <= max(5e-3 * abs(b), 1e-4):
            raise AssertionError(f"phase 5 {k}: kernel {a} vs f64 {b}")
    if not flips["kernel"] <= FLIP_RATIO * flips["plain"]:
        raise AssertionError(f"phase 5: the kernel step's pseudo masks differ from the f64 "
                             f"step's in {flips['kernel']} pixels, over {FLIP_RATIO}x the "
                             f"plain step's {flips['plain']}")
    log(f"phase 5 ok: qkv grads within {GRAD_REL} in norm, losses within 5e-3 relative of "
        f"the plain and the f64 step's, pseudo-mask flips within {FLIP_RATIO}x the plain's")


def _check_scores(what: str, rec) -> None:
    bad = {k: v for k, v in rec.items() if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
    if bad or not rec:
        raise AssertionError(f"{what}: mIoU not finite in [0, 1]: {bad or rec}")


def phase_scoring(smi: str):
    """The scoring path at the main path's width, three runs, each with its
    launch counts read exactly: (a) 4 training steps with a validation of
    student and teacher and a checkpoint at steps 2 and 4; (b) the final
    evaluation of (a)'s best-seg weights on the whole val split with the
    device DenseCRF; (c) (a) resumed from its step-2 checkpoint, whose
    step-3 and step-4 losses must be within 5e-3 relative of (a)'s (the
    same state and batches: the gap, printed, is what a different order of
    float sums on the card can leave). Returns each run's counts."""
    import shutil

    import torch

    from cosa_tpu_torch.data.loader import build_test_dataset
    from cosa_tpu_torch.eval.engine import score_names
    from cosa_tpu_torch.train.loop import LOSS_KEYS, finaleval, output_dir, train

    cfg = _main_cfg(name="score", max_iters=4, eval_iters=2, fasteval=True,
                    fasteval_n=16, finalval=True)
    out = output_dir(cfg)
    cfg_r = cfg.replace(name="score_resume", finalval=False,
                        resume=os.path.join(out, "ckpt", "step_00000002.pt"))
    for d in (out, output_dir(cfg_r)):
        shutil.rmtree(d, ignore_errors=True)
    # K1 per eval batch: 12 blocks at each scale (the flips ride in the batch)
    per_batch = 12 * len(cfg.eval_scales)
    per_val = 2 * -(-cfg.fasteval_n // cfg.eval_batch) * per_batch  # student, teacher
    counts = {}

    def run(tag, fn, **want):
        _reset_counts()
        res = fn()
        torch.cuda.synchronize()
        counts[tag] = _counts()
        if counts[tag] != _want(**want):
            raise AssertionError(f"phase 6 {tag}: launch counts {counts[tag]} != {_want(**want)}")
        return res

    res = run("train_and_validation", lambda: train(cfg, device="cuda"),
              flash_fwd=48 * 4 + 2 * per_val, flash_bwd=12 * 4, rff_phi=4 + 2)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        vals = [r for r in map(json.loads, f) if r["kind"] == "val"]
    if [(r["iter"], r["model"]) for r in vals] != [(2, "ON"), (2, "AN"), (4, "ON"), (4, "AN")]:
        raise AssertionError(f"phase 6: validations {vals}")
    for r in vals:
        _check_scores(f"validation {r['model']} @ {r['iter']}",
                      {k: v for k, v in r.items()
                       if k not in ("kind", "model", "iter", "wall_s")})
    for comment in ("seg", "cam"):
        if not os.path.exists(os.path.join(out, f"best_{comment}", "params.pt")):
            raise AssertionError(f"phase 6: best_{comment} was not saved")
    log(f"phase 6 validations: best seg {res['best_seg']:.2f}, best cam "
        f"{res['best_cam']:.2f}, launches {counts['train_and_validation']}")

    n_final = len(build_test_dataset(cfg))
    fin = run("final_eval", lambda: finaleval(cfg, device="cuda"),
              flash_fwd=-(-n_final // cfg.eval_batch) * per_batch)
    t = fin["time"]
    if t["images"] != n_final:
        raise AssertionError(f"phase 6 final eval: {t['images']} of {n_final} images scored")
    _check_scores("final eval", {k: fin[k]["miou"] for k in score_names(fin)})
    log(f"phase 6 eval: {t['images']} images at eval_batch {cfg.eval_batch}, scales "
        f"{list(cfg.eval_scales)}: {t['seconds'] / t['images']:.4f} s/image, CRF "
        f"{t['crf_seconds'] / t['images']:.4f} s/image ({t['crf_seconds'] / t['seconds']:.3f} "
        f"of it, crf_reduce {cfg.crf_reduce}, 640 canvas) on {smi}")
    log(f"phase 6 final eval mIoU: "
        f"{json.dumps({k: fin[k]['miou'] for k in score_names(fin)})}")

    resumed = run("resumed", lambda: train(cfg_r, device="cuda"),
                  flash_fwd=48 * 2 + per_val, flash_bwd=12 * 2, rff_phi=2 + 2)
    straight = {r["iter"]: r for r in res["records"]}
    if [r["iter"] for r in resumed["records"]] != [3, 4]:
        raise AssertionError(f"phase 6 resume: steps {[r['iter'] for r in resumed['records']]}")
    gap = 0.0
    for r in resumed["records"]:
        for k in LOSS_KEYS:
            a, b = r[k], straight[r["iter"]][k]
            if not abs(a - b) <= 5e-3 * abs(b):
                raise AssertionError(f"phase 6 resume: step {r['iter']} {k} {a} vs {b}")
            gap = max(gap, abs(a - b) / abs(b) if b else 0.0)
    log(f"phase 6 ok: resumed steps 3-4 within {gap:.3e} relative of the straight "
        f"run's losses (bound 5e-3); every mIoU finite in [0, 1]")
    return counts


def phase_microbench():
    """K4's path: the softmax microbenchmark's entry point, as a user runs
    it. Returns the launch counts of that run."""
    import torch

    from cosa_tpu_torch.cli import microbench_softmax as mb
    from cosa_tpu_torch.kernels import flash_variants

    _reset_counts()
    out = mb.run()
    torch.cuda.synchronize()
    counts = _counts()
    calls = len(mb.TOKENS) * (1 + mb.WARMUP + mb.REPS)  # cosine, warm-up, timed
    want = _want(flash_fwd=calls + len(mb.TOKENS),  # + K1's reference output
                 **{f"flash_fwd_{m}": calls for m in flash_variants.MODES})
    if counts != want:
        raise AssertionError(f"phase 7: launch counts {counts} != {want}")
    worst = min(r["cos_vs_prod"] for r in out)
    if not worst >= 0.9999:
        raise AssertionError(f"phase 7: cos_vs_prod {worst} < 0.9999")
    log(f"phase 7 ok: microbench_softmax, {len(out)} rows, cos_vs_prod >= {worst:.7f}, "
        f"launches {counts}")
    return counts


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
    phase_flash_vs_plain(convention)
    scoring = phase_scoring(smi)
    mb_counts = phase_microbench()
    for r in rows:
        # launches on the kernel's own path: training for K1-K3, the
        # microbenchmark for K4; the scoring path's runs beside them
        r["launches"] = (mb_counts if r["name"].startswith("flash_fwd_") else counts)[r["name"]]
        r["scoring_launches"] = {tag: c[r["name"]] for tag, c in scoring.items()}
        r["ok"] = True
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
