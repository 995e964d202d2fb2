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
     both block sizes and every (B*H, N) the paths launch it with, the
     distilled DeiT's and the pseudo pipeline's included, summed per
     training step, eval batch and pseudo-labelled image; K2 at the
     default's and the distilled student's N; K4 beside K1 at the same
     shape and block size; K3 beside a fill of its output);
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
  8. the opt-in training path at the same width: a ShapesWSSS tree in the
     VOC12 layout (cosa_tpu_torch/data/synthwsss.py), read as VOC12; the
     permutohedral-lattice energy, GMM thresholds, PAR and a reference-key
     pretrained .pth written here from a model seeded apart from the run; 4
     steps with 2 validations and a run resumed from step 2, exact launch
     counts (no RFF launch), the weights loaded, the thresholds moved, the
     resumed gap; the lattice on the card against the native C++ lattice
     on the host, twice against itself (bitwise), and its build against
     the CPU's build;
  9. the host CRF backends on phase 8's best-seg weights: evaluate with
     crf_backend "native" (the C++ lattice on the host) and "jax" at
     crf_reduce 1 (the lattice on the card), their labels held together;
 10. the pseudo-label pipeline, the submission and the visuals on phase
     8's tree and best-seg weights: the make_pseudo CLI over the 16 val
     images with PAR off and on, the native CRF on 4 of them, finaleval
     with eval_split "test" on a test split written from the val images
     (device CRF), evaluate with save_dir on 4 images; file counts,
     palette PNGs of each image's size, labels in range, finite mIoUs,
     exact launch counts, s/image;
 11. the other architectures at full width on phase 8's tree: 4 steps
     and a validation for the Maskformer decoder on ViT-B/16 (pretrained
     from an AugReg .npz) and for the distilled DeiT-B/16 (from a
     reference-key .pth with its dist_token), both files written from a
     model seeded apart; the weights in both encoders before step 1,
     finite losses, exact launch counts, sec/iter;
 12. the model zoo: Swin-B ``swinend2end`` at crop 448, batch 4, bf16 on
     phase 8's tree from an mmseg-key .pth written from a model seeded
     apart (4 steps, validations at steps 2 and 4, finaleval with the
     device CRF, a run resumed from step 2; K3 once a step, no K1/K2;
     sec/iter, s/image, peak memory); every seg-only family at its tiny
     config on the card against the CPU (1e-4), and at its published
     width, batch 2 at 512^2, one eval- and one train-mode forward
     (finite on its grid, BatchNorm statistics moved, ms per forward);
 13. the int8 teacher, the other optimizers and the legacy surface at the
     main path's width: the int8 dense (torch._int_mm) on the card against
     the CPU at the 672 scale's qkv and fc1 shapes (1 ulp, expected
     bitwise); the int8 microbenchmark (cli/microbench_int8.py); 4 steps
     of the default configuration with teacher_int8 at min_size 512 (the
     672 scale) and at 0 (every scale), exact launch counts and the int8
     products, sec/iter beside phase 4's; from one state and batch, one
     step with each against the bf16 teacher (the TTA CAMs' cosine > 0.98,
     the pseudo-mask pixels that differ); 3 steps each of cos_adamw,
     poly_sgd and poly_cls_sgd (the logged lr equals the schedule, losses
     finite, poly_cls_sgd with freeze_norm leaves the norms as they
     were); rrm.compute_joint_loss at crop 448 batch 4 (K3 once, within
     1e-3 of the CPU) and multi_scale_camseg_v2 on the bf16 ViT-B teacher
     (K1 at every scale, within 1e-5 of the live fuse in f32, the step's
     bf16 CAM fuse read beside it);
 14. multi-process runs of the main path (cosa_tpu_torch/parallel/): dp = 2
     and tp = 2 over gloo with both ranks on the one card, through
     train.loop.train (validation, checkpoint, a resumed step), each
     against one process at the same global batches (losses, the
     student's update and first moments, the validation, exact launches
     per rank); K1 at
     tp = 2's local head count against its plain version; the gloo
     all-reduce of the student's gradient on the card; NCCL at world size
     1 through torch.distributed.run and cli/train.py; dp = 2 over NCCL
     where there are two cards; sec/iter of each beside phase 4's;
 15. the run presets and reports (cli/run_synth.py, report_synth.py,
     parity_voc.py) on phase 8's tree: the synthrun preset at full width
     for 40 steps with validations at 20 and 40 and finaleval with the
     device CRF, report_synth's table and 2 panels of its best-seg
     weights, parity_voc on phase 8's best-seg weights (its per-class
     table equal to finaleval's result on them, its exit code the one
     that table implies); exact launch counts for each;
then print the kernels' JSON line, the card's name and power limit, and
the device JSON line last.

Phase 3 also times the opt-in path's torch ops (lattice build and apply,
the GMM thresholds, one PAR refine) at that path's shapes, each beside its
byte bound; they are no kernels and stay out of the kernels' JSON line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
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

# (B*H, N, caller) of every K1 launch on the paths, 12 blocks each: the
# default ViT's training step and eval batch, the distilled DeiT's (two
# prefix tokens: N + 1), and the pseudo-label pipeline's one image and its
# flip per forward
K1_SHAPES = (
    (96, 785, "teacher"), (96, 197, "teacher"), (96, 1765, "teacher"),
    (48, 785, "student"),
    (192, 197, "eval"), (192, 442, "eval"), (192, 785, "eval"), (192, 1226, "eval"),
    (192, 1765, "eval"),
    (96, 786, "teacher distilled"), (96, 198, "teacher distilled"),
    (96, 1766, "teacher distilled"), (48, 786, "student distilled"),
    (192, 198, "eval distilled"), (192, 443, "eval distilled"), (192, 786, "eval distilled"),
    (192, 1227, "eval distilled"), (192, 1766, "eval distilled"),
    (24, 785, "pseudo"), (24, 197, "pseudo"), (24, 1765, "pseudo"),
)
# what one K1 launch at a caller's shapes adds up to: a training step, an
# eval batch, one pseudo-labelled image
K1_SUMS = {"teacher": "step", "student": "step", "eval": "eval batch",
           "teacher distilled": "distilled step", "student distilled": "distilled step",
           "eval distilled": "distilled eval batch", "pseudo": "pseudo image"}


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
    # (eval_batch 8 and its flips) per eval batch, the same for the distilled
    # DeiT, and the pseudo pipeline's three scales per image. Each shape is
    # timed at both block sizes: the launcher's rule
    # (kernels/flash.py::block_rows) is meant to take the faster, and the
    # derived line names any shape where it did not. The shapes that no
    # check above holds (the distilled and pseudo callers') are held here
    sums = {w: [0.0, 0.0] for w in dict.fromkeys(K1_SUMS.values())}  # kernel, sdpa ms
    slower = []  # shapes where the rule's block size read slower
    for bh, n, where in K1_SHAPES:
        bk = bh // h
        qkv = _qkv(bk, n, h, gen)
        if where.endswith(("distilled", "pseudo")):
            q, k, v = _split(qkv, h)
            ref = flash.plain_attention(q, k, v, scale).reshape(bk, n, h * 64)
            o, _ = flash.attn_fwd(qkv, h, scale)
            torch.cuda.synchronize()
            err = float((o.float() - ref).abs().max())
            log(f"  K1 N={n} B*H={bh} ({where}) {flash.block_rows(n)} queries per block: "
                f"max|kernel - plain f32| = {err:.3e}")
            if not err < 5e-3:
                failures.append(f"K1 N={n} B*H={bh} ({where}): {err}")
            k1[(n, bh, where)] = err
            del q, k, v, ref
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
        tot = sums[K1_SUMS[where]]
        tot[0] += 12 * ms
        tot[1] += 12 * lib
        if where == "student":
            fwd_row = dict(
                name="flash_fwd", route="cuda",
                source="cosa_tpu_torch/csrc/flash_attn.cu",
                replaces="cosa_tpu/kernels/flash.py:201",
                shape=f"B*H={bh} N={n} D=64 bf16",
                max_abs_err=None, ms=ms, plain_ms=plain,
                bound_ms=bms, bound_by=by, library_ms=lib,
            )
    fwd_row["max_abs_err"] = max(k1.values())
    rows.append(fwd_row)
    log("  K1 derived: " + ", ".join(f"{k:.3f} ms per {w} (sdpa {lib:.3f})"
                                     for w, (k, lib) in sums.items())
        + f"; the rule's block size read slower than the other at "
          f"{', '.join(slower) or 'no shape'}")

    # ---- K2 backward vs plain f32 autograd on the same bf16 inputs
    k2_err = 0.0
    for n, nv in ((785, None), (197, 160), (786, None)):
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
    # ---- K2 times at the student's shape, the default ViT's and the
    # distilled DeiT's (the row keeps the default's)
    for n in (785, 786):
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
        fw = torch.ops.aten._scaled_dot_product_flash_attention(
            qh, kh, vh, 0.0, False, False, scale=scale)
        gh = dout.reshape(b, n, h, 64).transpose(1, 2).contiguous()
        lib = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
            gh, qh, kh, vh, fw[0], fw[1], fw[2], fw[3], fw[4], fw[5], 0.0, False,
            fw[6], fw[7], scale=scale))
        flops = 10.0 * b * h * n * n * 64
        nbytes = 8.0 * b * h * n * 64 * 2 + b * h * n * 4
        bms, by = bound_ms(nbytes, flops, PEAK_BF16)
        log(f"  K2 N={n} B*H={b * h}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa-flash bwd {lib:.4f} ms ({ms / lib:.2f}x), bound {bms:.4f} ms ({by}); "
            f"derived {12 * ms:.3f} ms per training step (library {12 * lib:.3f})")
        if n == 785:
            rows.append(dict(
                name="flash_bwd", route="cuda", source="cosa_tpu_torch/csrc/flash_attn.cu",
                replaces="cosa_tpu/kernels/flash.py:228", shape=f"B*H={b * h} N={n} D=64 bf16",
                max_abs_err=k2_err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib,
            ))
        del qkv, dout, o, lse, xb, ref_o, fw

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
        "masked and not, and at every distilled and pseudo (B*H, N); K2 dq/dk/dv rel "
        "err < 1e-2 (N 785, 197, 786); K3 max err vs f64 < 3e-4 "
        "(bf16), < 1e-5 (f32); K4 max err <= 1e-2 and cos vs K1 >= 0.9999 "
        f"({json.dumps(k4)})")
    return rows


def phase_opt_in_ops(smi: str):
    """The opt-in path's torch ops at its shapes, eager, by CUDA events,
    each beside the least time its bytes take at 3.35 TB/s (inputs read
    once, outputs written once): the energy lattice's build and apply at
    (4, 224*224, 5) with 21 classes, the GMM thresholds on the (400, 784)
    queue with 100 EM iterations, one PAR refine of (4, 224, 224, 21)."""
    import torch

    from cosa_tpu_torch.ops.gmm import gmm_thresholds
    from cosa_tpu_torch.ops.par import par_refine
    from cosa_tpu_torch.ops.permutohedral import apply_lattice, build_lattice

    gen = torch.Generator(device="cuda").manual_seed(7)
    n = 224 * 224
    img = torch.randint(0, 256, (4, 224, 224, 3), generator=gen, device="cuda").float()
    ys, xs = torch.meshgrid(torch.arange(224.0, device="cuda"),
                            torch.arange(224.0, device="cuda"), indexing="ij")
    feats = torch.cat([torch.stack([xs, ys], -1).expand(4, -1, -1, -1) / 50.0, img / 15.0],
                      dim=-1).reshape(4, n, 5)
    vals = torch.softmax(torch.randn((4, n, 21), generator=gen, device="cuda"), dim=-1)
    lat = build_lattice(feats)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = [
        ("lattice build (4, 50176, 5)", lambda: build_lattice(feats), nbytes(feats, *lat), 5),
        ("lattice apply (4, 50176, 21)", lambda: apply_lattice(lat, vals),
         nbytes(vals, vals, *lat), 10),
    ]
    queue = torch.rand((400, 784), generator=gen, device="cuda")
    rows.append(("gmm_thresholds (400, 784), 100 EM iterations",
                 lambda: gmm_thresholds(queue, 0.05, 3, 100, 8), nbytes(queue) + 8, 5))
    imgs = torch.rand((4, 224, 224, 3), generator=gen, device="cuda")
    masks = torch.softmax(torch.randn((4, 224, 224, 21), generator=gen, device="cuda"), -1)
    rows.append(("par_refine (4, 224, 224, 21), 10 sweeps of 48 shifts",
                 lambda: par_refine(imgs, masks), nbytes(imgs, masks, masks), 3))
    out = {}
    for name, fn, nb, reps in rows:
        ms = time_ms(fn, reps=reps, warmup=1, graph=False)
        bms = nb / PEAK_BYTES * 1e3
        out[name] = ms
        log(f"phase 3 torch op {name}: {ms:.4f} ms, byte bound {bms:.4f} ms "
            f"({nb / 1e6:.1f} MB), {bms / ms:.4f} of the bound, on {smi}")
    return out


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
    return counts, res["energy_convention"], med


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
    return counts, t


OPTIN_TRAIN, OPTIN_VAL = 32, 16  # ShapesWSSS images of phase 8's tree
PRETRAINED_SEED = 4242  # the pretrained file's model, seeded apart from the run


def _optin_cfg(root, **kw):
    """Phase 8's configuration: the VOC default at full width on a
    ShapesWSSS tree, with the lattice energy, GMM and PAR."""
    base = dict(
        backbone="vit_base_patch16_224", crop_size=448, batch_size=4, mixed_precision=True,
        data_root=root, split_dir=os.path.join(root, "splits"), max_iters=4, warmup_iters=2,
        lr_warmup_iters=2, log_iters=1, eval_iters=2, fasteval=True, fasteval_n=OPTIN_VAL,
        finalval=False, energy_filter="lattice", usegmm=True, usepar=True,
        work_dir=os.path.join(ROOT, "build", "chip_smoke"),
    )
    base.update(kw)
    from cosa_tpu_torch.config import preset_config

    return preset_config("VOC12", **base)


@contextmanager
def _patched(module, name, wrap):
    """``module.name`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def phase_optin(smi: str):
    """The opt-in training path (phase 8). Returns each run's launch counts,
    the run's directory and configuration."""
    import shutil

    import numpy as np
    import torch

    import cosa_tpu_torch.objectives.energy as energy_mod
    import cosa_tpu_torch.train.loop as loop_mod
    from cosa_tpu_torch.cli import make_synth_data
    from cosa_tpu_torch.models.network import build_model
    from cosa_tpu_torch.native.build import lattice_gaussian_cpu
    from cosa_tpu_torch.ops.permutohedral import apply_lattice, build_lattice

    root = os.path.join(ROOT, "build", "chip_smoke", "shapes_voc")
    shutil.rmtree(root, ignore_errors=True)
    make_synth_data.main(["--root", root, "--n_train", str(OPTIN_TRAIN),
                          "--n_val", str(OPTIN_VAL), "--seed", "0"])
    pre = os.path.join(ROOT, "build", "chip_smoke", "pretrained.pth")
    cfg = _optin_cfg(root, name="optin", pretrained_path=pre)
    torch.save(build_model(cfg, "cpu", seed=PRETRAINED_SEED).state_dict(), pre)
    out = loop_mod.output_dir(cfg)
    cfg_r = cfg.replace(name="optin_resume", resume=os.path.join(out, "ckpt", "step_00000002.pt"))
    for d in (out, loop_mod.output_dir(cfg_r)):
        shutil.rmtree(d, ignore_errors=True)
    per_val = 2 * -(-OPTIN_VAL // cfg.eval_batch) * 12 * len(cfg.eval_scales)

    loaded, first, thre = [], {}, {"optin": [], "optin_resume": []}

    def checking(load):  # before step 1: both encoders hold the file's weights
        def fn(c, state):
            load(c, state)
            sd = torch.load(pre, map_location="cpu", weights_only=True)
            for model in (state.student, state.teacher):
                own = model.state_dict()
                loaded.append(all(torch.equal(own[k].cpu(), v) for k, v in sd.items()
                                  if k.startswith("encoder.")))
            return state
        return fn

    def first_feats(build):
        def fn(feats):
            first.setdefault("feats", feats.clone())
            return build(feats)
        return fn

    def first_values(apply):
        def fn(lat, values, *a, **kw):
            first.setdefault("values", values.detach().clone())
            return apply(lat, values, *a, **kw)
        return fn

    def thresholds(into):  # each step's (low, high) as the step logs them
        def wrap(build):
            def build_step(c, mesh):
                step = build(c, mesh)

                def fn(state, batch):
                    m = step(state, batch)
                    into.append(torch.stack([m["thre_low"], m["thre_high"]]).clone())
                    return m
                return fn
            return build_step
        return wrap

    counts = {}

    def run(tag, c, **want):
        _reset_counts()
        with _patched(loop_mod, "build_train_step", thresholds(thre[tag])):
            res = loop_mod.train(c, device="cuda")
        torch.cuda.synchronize()
        counts[tag] = _counts()
        if counts[tag] != _want(**want):
            raise AssertionError(f"phase 8 {tag}: launch counts {counts[tag]} != {_want(**want)}")
        return res

    with _patched(loop_mod, "load_pretrained_into_state", checking), \
            _patched(energy_mod, "build_lattice", first_feats), \
            _patched(energy_mod, "apply_lattice", first_values):
        res = run("optin", cfg, flash_fwd=48 * 4 + 2 * per_val, flash_bwd=12 * 4)
    if loaded != [True, True]:
        raise AssertionError(f"phase 8: pretrained encoder weights in student, teacher: {loaded}")
    recs = res["records"]
    for r in recs:
        if not all(math.isfinite(r[k]) for k in loop_mod.LOSS_KEYS):
            raise AssertionError(f"phase 8: non-finite loss at iter {r['iter']}: {r}")
    if not all(r["reg_loss"] != 0.0 for r in recs if r["iter"] > cfg.warmup_iters):
        raise AssertionError(f"phase 8: zero reg_loss after warmup: {recs}")
    low, high = (float(v) for v in thre["optin"][0].cpu())
    if not (0.0 < low < high < 1.0 and (low, high) != (cfg.low_thre, cfg.high_thre)):
        raise AssertionError(f"phase 8: thresholds after step 1: low {low}, high {high}")
    log(f"phase 8 opt-in run: pretrained weights in both encoders before step 1; thresholds "
        f"after step 1 low {low:.6f} high {high:.6f} (fixed {cfg.low_thre}, "
        f"{cfg.high_thre}); launches {counts['optin']}")

    resumed = run("optin_resume", cfg_r, flash_fwd=48 * 2 + per_val, flash_bwd=12 * 2)
    if [r["iter"] for r in resumed["records"]] != [3, 4]:
        raise AssertionError(f"phase 8 resume: steps {[r['iter'] for r in resumed['records']]}")
    straight = {r["iter"]: r for r in recs}
    gap = 0.0
    pairs = [(r[k], straight[r["iter"]][k])
             for r in resumed["records"] for k in loop_mod.LOSS_KEYS]
    pairs += list(zip(torch.cat(thre["optin_resume"]).tolist(),
                      torch.cat(thre["optin"][2:]).tolist()))
    for a, b in pairs:
        if not abs(a - b) <= 5e-3 * abs(b):
            raise AssertionError(f"phase 8 resume: {a} vs {b}")
        gap = max(gap, abs(a - b) / abs(b) if b else 0.0)
    resumed_times = ", ".join(f"{r['itertime']:.4f}" for r in resumed["records"])
    log(f"phase 8 sec/iter: median {statistics.median(r['itertime'] for r in recs[1:]):.4f} s "
        f"over steps 2-4, resumed steps 3-4 {resumed_times} s, on {smi}")

    # the lattice on the card against the native C++ lattice on the host, on
    # the first batch's energy features and probabilities; twice on the card
    feats, vals = first["feats"], first["values"]
    lat, lat2 = build_lattice(feats), build_lattice(feats)
    card, again = apply_lattice(lat, vals), apply_lattice(lat2, vals)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(lat, lat2)) and torch.equal(card, again)
    f_np, v_np = feats.cpu().numpy(), vals.cpu().numpy()
    host = np.stack([lattice_gaussian_cpu(f_np[i], v_np[i]) for i in range(f_np.shape[0])])
    rel = float(np.linalg.norm(card.cpu().numpy() - host) / np.linalg.norm(host))
    log(f"phase 8 lattice: card vs native C++ relative error {rel:.3e} (bound 1e-4) on "
        f"{tuple(vals.shape)}; two builds and applies on the card bitwise equal: {same}")
    if not (rel < 1e-4 and same):
        raise AssertionError(f"phase 8 lattice: rel err {rel}, bitwise repeatable {same}")
    # the first image's lattice built on the card against the CPU's build.
    # Its flat-coloured shapes put points on exact ties of the simplex
    # ranks, which the card's f32 embedding may break the other way: such
    # a point takes another vertex at (near) zero weight, so the structure
    # is reported and the filters are held together
    card1, cpu1 = build_lattice(feats[0]), build_lattice(feats[0].cpu())
    fields = ("uid", "nbr_idx", "nbr_ok", "order", "counts")
    unequal = [n for n in fields if not torch.equal(getattr(card1, n).cpu(), getattr(cpu1, n))]
    moved = int((card1.uid.cpu() != cpu1.uid).any(dim=-1).sum())
    bary_gap = float((card1.bary.cpu() - cpu1.bary).abs().max())
    f_card = apply_lattice(card1, vals[0]).cpu()
    f_cpu = apply_lattice(cpu1, vals[0].cpu())
    rel1 = float(torch.linalg.norm(f_card - f_cpu) / torch.linalg.norm(f_cpu))
    log(f"phase 8 lattice: card vs CPU build of image 0: fields unequal {unequal}, points "
        f"with another vertex {moved} of {feats.shape[1]}, bary max abs gap {bary_gap:.3e}; "
        f"filter relative error {rel1:.3e} (bound 1e-5)")
    if not rel1 < 1e-5:
        raise AssertionError(f"phase 8 lattice: card vs CPU build, filter rel err {rel1}")
    log(f"phase 8 ok: resumed steps 3-4 within {gap:.3e} relative of the straight run's "
        f"losses and thresholds (bound 5e-3); losses finite, reg_loss nonzero after warmup")
    return counts, out, cfg


def phase_host_crf(smi: str, out: str, cfg, device_time):
    """Phase 9: evaluate phase 8's best-seg weights on 4 val images with the
    CRF on the host (C++ lattice) and on the card (lattice, crf_reduce 1);
    both backends' labels agree on > 0.98 of the pixels (the JAX package's
    bound, tests/test_crf.py). Returns each run's launch counts."""
    import numpy as np
    import torch

    import cosa_tpu_torch.eval.engine as engine_mod
    from cosa_tpu_torch.data.loader import build_val_dataset
    from cosa_tpu_torch.eval.engine import evaluate, score_names
    from cosa_tpu_torch.models.network import build_model
    from cosa_tpu_torch.train import checkpoint as ckpt

    model = ckpt.load_best(out, "seg", build_model(cfg, "cuda"))
    val_ds = build_val_dataset(cfg)
    n_img = 4
    labels, counts = {}, {}
    for backend in ("native", "jax"):
        c = cfg.replace(crf_backend=backend, crf_reduce=1)
        into = labels[backend] = []
        _reset_counts()
        with _patched(engine_mod, "crf_refine_host", lambda f: _recording(f, into)):
            res = evaluate(c, model, val_ds, getcrf=True, max_images=n_img, device="cuda")
        torch.cuda.synchronize()
        counts[f"crf_{backend}"] = _counts()
        want = _want(flash_fwd=n_img * 12 * len(c.eval_scales))
        if counts[f"crf_{backend}"] != want:
            raise AssertionError(f"phase 9 {backend}: launch counts {counts[f'crf_{backend}']} "
                                 f"!= {want}")
        _check_scores(f"phase 9 {backend}", {k: res[k]["miou"] for k in score_names(res)})
        t = res["time"]
        log(f"phase 9 crf_backend {backend!r} (crf_reduce 1): {t['seconds'] / t['images']:.4f} "
            f"s/image, CRF {t['crf_seconds'] / t['images']:.4f} s/image "
            f"({t['crf_seconds'] / t['seconds']:.3f} of it), Seg_crf mIoU "
            f"{res['Seg_crf']['miou']:.4f}, on {smi}; phase 6's device backend "
            f"{device_time['seconds'] / device_time['images']:.4f} s/image, CRF "
            f"{device_time['crf_seconds'] / device_time['images']:.4f}")
    sizes = [a.numel() for a in labels["native"]]
    agree = sum(int((a == b).sum()) for a, b in zip(labels["native"], labels["jax"])) / sum(sizes)
    if len(labels["jax"]) != n_img or not agree > 0.98:
        raise AssertionError(f"phase 9: native vs lattice CRF labels agree on {agree}")
    log(f"phase 9 ok: native and on-card lattice CRF labels agree on {agree:.5f} of "
        f"{sum(sizes)} pixels (bound 0.98); every mIoU finite in [0, 1]")
    return counts


def _timed(into: dict, tag: str):
    """A wrapper of a function that records its result and its seconds,
    from one synchronised card to the next, under ``tag``."""
    import time

    import torch

    def wrap(fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            into[tag] = (res, time.time() - t0)
            return res
        return run
    return wrap


def _check_labels(what: str, directory: str, sizes: dict, ignore: bool) -> None:
    """One palette PNG per image of ``sizes`` ({name: (h, w)}) in
    ``directory``, each of its image's size, labels < 21 (or 255 where
    ``ignore``)."""
    import numpy as np
    from PIL import Image

    got = sorted(os.listdir(directory))
    if got != sorted(f"{n}.png" for n in sizes):
        raise AssertionError(f"{what}: files {got[:4]}... ({len(got)}) for {len(sizes)} images")
    for name, hw in sizes.items():
        png = Image.open(os.path.join(directory, name + ".png"))
        lab = np.asarray(png)
        ok = (lab < 21) | (lab == 255) if ignore else lab < 21
        if png.mode != "P" or lab.shape != tuple(hw) or not ok.all():
            raise AssertionError(f"{what} {name}: mode {png.mode}, shape {lab.shape} vs {hw}, "
                                 f"labels {np.unique(lab)[:8]}")


def phase_pseudo_submission(smi: str, out: str, cfg):
    """Phase 10, on phase 8's ShapesWSSS tree and best-seg weights: the
    make_pseudo CLI over the 16 val images with PAR off and on, the CRF
    (crf_backend "device": the native C++ lattice on the host) on the
    first 4, finaleval with eval_split "test" on a test split written from
    the val images (device CRF), and evaluate with save_dir on 4 val
    images. Returns each run's launch counts."""
    import shutil

    import numpy as np
    import torch

    import cosa_tpu_torch.eval.pseudo_pipeline as pp
    import cosa_tpu_torch.train.loop as loop_mod
    from cosa_tpu_torch.cli import make_pseudo
    from cosa_tpu_torch.data.loader import build_val_dataset
    from cosa_tpu_torch.eval.engine import eval_indices, evaluate, score_names
    from cosa_tpu_torch.eval.submit import submission_dir
    from cosa_tpu_torch.models.network import build_model
    from cosa_tpu_torch.train import checkpoint as ckpt

    root, weights = cfg.data_root, os.path.join(out, "best_seg", "params.pt")
    val_ds = build_val_dataset(cfg)
    names = list(val_ds.base.names)
    sizes = {n: val_ds[i]["image"].shape[:2] for i, n in enumerate(names)}
    per_image = 12 * len(cfg.pseudo_scales)
    counts, timed = {}, {}

    def run(tag, fn, **want):
        _reset_counts()
        res = fn()
        torch.cuda.synchronize()
        counts[tag] = _counts()
        if counts[tag] != _want(**want):
            raise AssertionError(f"phase 10 {tag}: launch counts {counts[tag]} != {_want(**want)}")
        return res

    def check_pseudo(tag, directory, subset, note=""):
        _check_labels(f"phase 10 {tag}", os.path.join(directory, "mask"), subset, ignore=True)
        for n in subset:
            cam = np.load(os.path.join(directory, "cam", n + ".npy"))
            if cam.shape != (cfg.crop_size, cfg.crop_size, 20) or not np.isfinite(cam).all():
                raise AssertionError(f"phase 10 {tag} {n}: CAM {cam.shape}")
        res, secs = timed[tag]
        _check_scores(f"phase 10 {tag}", {"miou": res["miou"]})
        log(f"phase 10 {tag}{note}: {len(subset)} images, {secs / len(subset):.4f} s/image, mIoU "
            f"{res['miou']:.4f}, launches {counts[tag]}, on {smi}")

    flags = ["--dataset", "VOC12", "--data_root", root, "--split_dir", cfg.split_dir,
             "--backbone", cfg.backbone, "--crop_size", str(cfg.crop_size),
             "--pretrained_path", weights, "--work_dir", cfg.work_dir]
    for tag, par in (("pseudo", "false"), ("pseudo_par", "true")):
        shutil.rmtree(os.path.join(cfg.work_dir, tag), ignore_errors=True)
        with _patched(pp, "generate_pseudo_labels", _timed(timed, tag)):
            run(tag, lambda: make_pseudo.main([tag, *flags, "--usepar", par]),
                flash_fwd=len(names) * per_image)
        check_pseudo(tag, os.path.join(cfg.work_dir, tag, "pseudo"), sizes)

    model = ckpt.load_best(out, "seg", build_model(cfg, "cuda"))
    crf_dir = os.path.join(cfg.work_dir, "pseudo_crf")
    shutil.rmtree(crf_dir, ignore_errors=True)
    n_crf = 4
    crf = _timed(timed, "pseudo_crf")(pp.generate_pseudo_labels)
    run("pseudo_crf", lambda: crf(cfg.replace(usepar=False), model, val_ds, crf_dir,
                                  max_images=n_crf, use_crf=True, device="cuda"),
        flash_fwd=n_crf * per_image)
    check_pseudo("pseudo_crf", crf_dir, {n: sizes[n] for n in names[:n_crf]},
                 " (the native C++ CRF on the host)")

    # the test split: the val images under JPEGImages_test, as VOC lays it out
    os.makedirs(os.path.join(root, "JPEGImages_test"), exist_ok=True)
    for n in names:
        shutil.copy(os.path.join(root, "JPEGImages", n + ".jpg"),
                    os.path.join(root, "JPEGImages_test", n + ".jpg"))
    with open(os.path.join(cfg.split_dir, "voc", "test.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    cfg_s = cfg.replace(name="submit", eval_split="test", pretrained_path=weights)
    shutil.rmtree(loop_mod.output_dir(cfg_s), ignore_errors=True)
    buckets = {}
    for hw in sizes.values():
        pad = 500 if max(hw) <= 500 else -(-max(hw) // 128) * 128
        buckets[pad] = buckets.get(pad, 0) + 1
    batches = sum(-(-k // cfg.eval_batch) for k in buckets.values())
    with _patched(loop_mod, "dump_submission", _timed(timed, "submission")):
        res = run("submission", lambda: loop_mod.finaleval(cfg_s, device="cuda"),
                  flash_fwd=batches * 12 * len(cfg.eval_scales))
    dst = submission_dir(loop_mod.output_dir(cfg_s))
    if res != {"submission_dir": dst}:
        raise AssertionError(f"phase 10 submission: {res}")
    _check_labels("phase 10 submission", dst, sizes, ignore=False)
    secs = timed["submission"][1]
    log(f"phase 10 submission: {len(sizes)} test images in canvases {buckets}, device CRF "
        f"(crf_reduce {cfg.crf_reduce}): {secs / len(sizes):.4f} s/image, launches "
        f"{counts['submission']}, on {smi}")

    vis_dir = os.path.join(cfg.work_dir, "visuals")
    shutil.rmtree(vis_dir, ignore_errors=True)
    n_vis = 4
    res = run("visuals", lambda: evaluate(cfg, model, val_ds, max_images=n_vis,
                                          save_dir=vis_dir, device="cuda"),
              flash_fwd=-(-n_vis // cfg.eval_batch) * 12 * len(cfg.eval_scales))
    _check_scores("phase 10 visuals", {k: res[k]["miou"] for k in score_names(res)})
    picked = [val_ds[i] for i in eval_indices(len(val_ds), n_vis)]
    _check_labels("phase 10 visuals", os.path.join(vis_dir, "seg"),
                  {smp["name"]: smp["image"].shape[:2] for smp in picked}, ignore=False)
    n_cls = int(sum(smp["cls_label"].sum() for smp in picked))
    for sub in ("cam", "merged"):
        got = len(os.listdir(os.path.join(vis_dir, sub)))
        if got != n_cls:
            raise AssertionError(f"phase 10 visuals: {got} files in {sub}/, {n_cls} expected")
    log(f"phase 10 ok: pseudo masks, CAMs, submission and visuals: file counts, palette "
        f"PNGs of each image's size, labels in range, mIoUs finite; visuals {n_vis} seg, "
        f"{n_cls} cam and merged images; launches {counts['visuals']}")
    return counts


def _write_augreg(sd, path: str, vcfg) -> None:
    """The encoder of a reference-key state dict as an original
    vision_transformer / AugReg .npz, the layout
    models/convert.py::state_dict_from_augreg_npz reads."""
    import numpy as np

    d, h = vcfg.embed_dim, vcfg.num_heads

    def g(k):
        return sd["encoder." + k].numpy()

    z = {"embedding/kernel": g("patch_embed.proj.weight").transpose(2, 3, 1, 0),
         "embedding/bias": g("patch_embed.proj.bias"), "cls": g("cls_token"),
         "Transformer/posembed_input/pos_embedding": g("pos_embed"),
         "Transformer/encoder_norm/scale": g("norm.weight"),
         "Transformer/encoder_norm/bias": g("norm.bias")}
    for i in range(vcfg.depth):
        b, pre = f"Transformer/encoderblock_{i}/", f"blocks.{i}."
        att = b + "MultiHeadDotProductAttention_1/"
        kernels = np.split(g(pre + "attn.qkv.weight").T, 3, axis=1)
        biases = np.split(g(pre + "attn.qkv.bias"), 3)
        for n, k, bias in zip(("query", "key", "value"), kernels, biases):
            z[att + f"{n}/kernel"] = k.reshape(d, h, d // h)
            z[att + f"{n}/bias"] = bias.reshape(h, d // h)
        z[att + "out/kernel"] = g(pre + "attn.proj.weight").T.reshape(h, d // h, d)
        z[att + "out/bias"] = g(pre + "attn.proj.bias")
        for k, name in (("0", "norm1"), ("2", "norm2")):
            z[b + f"LayerNorm_{k}/scale"] = g(pre + name + ".weight")
            z[b + f"LayerNorm_{k}/bias"] = g(pre + name + ".bias")
        for k, name in (("0", "fc1"), ("1", "fc2")):
            z[b + f"MlpBlock_3/Dense_{k}/kernel"] = g(pre + f"mlp.{name}.weight").T
            z[b + f"MlpBlock_3/Dense_{k}/bias"] = g(pre + f"mlp.{name}.bias")
    np.savez(path, **z)


def phase_variants(smi: str, root: str):
    """Phase 11, on phase 8's ShapesWSSS tree with the default (RFF)
    energy: 4 training steps and a validation of student and teacher at
    step 4 for (a) the Maskformer decoder on ViT-B/16, pretrained from an
    AugReg .npz, and (b) the distilled DeiT-B/16 with LargeFOV, pretrained
    from a reference-key .pth with its dist_token; each file is written
    here from a model seeded apart from the run. Held: the file's weights
    in both encoders before step 1, finite losses, exact launch counts.
    Returns each run's launch counts."""
    import shutil

    import torch

    import cosa_tpu_torch.train.loop as loop_mod
    from cosa_tpu_torch.models.network import build_model
    from cosa_tpu_torch.models.vit import BACKBONES

    counts = {}
    for tag, kw, ext in (("maskformer", dict(decoder="Maskformer"), "npz"),
                         ("distilled", dict(backbone="deit_base_distilled_patch16_224"), "pth")):
        pre = os.path.join(ROOT, "build", "chip_smoke", f"pretrained_{tag}.{ext}")
        cfg = _optin_cfg(root, name=tag, energy_filter="rff", usegmm=False, usepar=False,
                         eval_iters=4, pretrained_path=pre, **kw)
        src = build_model(cfg, "cpu", seed=PRETRAINED_SEED).state_dict()
        if ext == "npz":
            _write_augreg(src, pre, BACKBONES[cfg.backbone])
        else:
            torch.save(src, pre)
        shutil.rmtree(loop_mod.output_dir(cfg), ignore_errors=True)
        loaded = []

        def checking(load):  # before step 1: both encoders hold the file's weights
            def fn(c, state):
                load(c, state)
                for model in (state.student, state.teacher):
                    own = model.state_dict()
                    loaded.append(all(torch.equal(own[k].cpu(), v) for k, v in src.items()
                                      if k.startswith("encoder.")))
                return state
            return fn

        per_val = 2 * -(-OPTIN_VAL // cfg.eval_batch) * 12 * len(cfg.eval_scales)
        _reset_counts()
        with _patched(loop_mod, "load_pretrained_into_state", checking):
            res = loop_mod.train(cfg, device="cuda")
        torch.cuda.synchronize()
        counts[tag] = _counts()
        want = _want(flash_fwd=48 * 4 + per_val, flash_bwd=12 * 4, rff_phi=4 + 2)
        if counts[tag] != want:
            raise AssertionError(f"phase 11 {tag}: launch counts {counts[tag]} != {want}")
        if loaded != [True, True] or (ext == "pth") != ("encoder.dist_token" in src):
            raise AssertionError(f"phase 11 {tag}: pretrained encoder weights in student, "
                                 f"teacher: {loaded}")
        recs = res["records"]
        if len(recs) != 4 or not all(math.isfinite(r[k]) for r in recs
                                     for k in loop_mod.LOSS_KEYS):
            raise AssertionError(f"phase 11 {tag}: losses {recs}")
        if not math.isfinite(res["best_seg"]) or res["best_seg"] < 0:
            raise AssertionError(f"phase 11 {tag}: no validation ({res['best_seg']})")
        med = statistics.median(r["itertime"] for r in recs[1:])
        log(f"phase 11 {tag} ({cfg.backbone}, {cfg.decoder}, pretrained {ext}): sec/iter "
            f"median {med:.4f} s over steps 2-4, best seg {res['best_seg']:.2f}, last losses "
            f"{json.dumps({k: recs[-1][k] for k in loop_mod.LOSS_KEYS})}, launches "
            f"{counts[tag]}, on {smi}")
    log("phase 11 ok: the file's weights in both encoders before step 1, losses finite, "
        "a validation at step 4, exact launch counts")
    return counts


def _mmseg_swin_keys(sd):
    """The backbone of a port SwinNetwork state dict under the mmseg/mmcv
    Swin keys (the inverse of models/convert.py::state_dict_from_mmseg_swin),
    with the stage norms norm0-norm2 that an mmseg file also holds."""
    import re

    import torch

    out = {}
    for k, v in sd.items():
        if not k.startswith("backbone."):
            continue
        k = k[len("backbone."):]
        for pat, rep in ((r"^patch_embed\.", "patch_embed.projection."),
                         (r"^patch_norm\.", "patch_embed.norm."),
                         (r"^stage(\d+)_block(\d+)\.", r"stages.\1.blocks.\2."),
                         (r"^merge(\d+)\.", r"stages.\1.downsample."),
                         (r"\.attn\.rel_pos_bias$", ".attn.w_msa.relative_position_bias_table"),
                         (r"\.attn\.(qkv|proj)\.", r".attn.w_msa.\1."),
                         (r"\.fc1\.", ".ffn.layers.0.0."), (r"\.fc2\.", ".ffn.layers.1.")):
            k = re.sub(pat, rep, k)
        out["backbone." + k] = v
    width = out["backbone.norm3.weight"].shape[0]
    for i in range(3):
        c = width >> (3 - i)
        out[f"backbone.norm{i}.weight"], out[f"backbone.norm{i}.bias"] = torch.ones(c), torch.zeros(c)
    return out


def _zoo_families():
    """Phase 12's seg-only families: (name, the model at its published
    width for 21 classes in ``dtype``, the model at its tiny test config
    (tests/test_torch_zoo.py) in f32, its output grid at a 512 input, the
    forward's keyword arguments: the mmseg models' auxiliary head too)."""
    from cosa_tpu_torch.models import zoo as z

    r1, aux = (1, 1, 1, 1), {"aux": True}
    return [
        ("segformer_mit_b5", lambda dt: z.SegFormer(21, "mit_b5", dtype=dt),
         lambda: z.SegFormer(7, "mit_tiny_test"), 128, {}),
        ("wrn38", lambda dt: z.WRN38Seg(21, dtype=dt), lambda: z.WRN38Seg(7, width_div=32), 64, {}),
        ("deeplab_v1_r101", lambda dt: z.DeepLabV1(21, dtype=dt),
         lambda: z.DeepLabV1(7, n_blocks=r1), 65, {}),
        ("deeplab_v1_largefov_r101", lambda dt: z.DeepLabV1LargeFOV(21, dtype=dt),
         lambda: z.DeepLabV1LargeFOV(7, n_blocks=r1), 65, {}),
        ("deeplab_v2_r101", lambda dt: z.DeepLabV2(21, dtype=dt),
         lambda: z.DeepLabV2(7, n_blocks=r1), 65, {}),
        ("deeplab_v3_r101", lambda dt: z.DeepLabV3(21, dtype=dt),
         lambda: z.DeepLabV3(7, n_blocks=r1), 33, {}),
        ("deeplab_v3plus_r101", lambda dt: z.DeepLabV3Plus(21, dtype=dt),
         lambda: z.DeepLabV3Plus(7, n_blocks=r1), 512, {}),
        ("deeplab_v1_vgg16", lambda dt: z.DeepLabV1VGG16(21, dtype=dt),
         lambda: z.DeepLabV1VGG16(7), 64, {}),
        ("deeplab_v2_vgg16", lambda dt: z.DeepLabV2VGG16(21, dtype=dt),
         lambda: z.DeepLabV2VGG16(7), 64, {}),
        ("msc_deeplab_v2_r101", lambda dt: z.MSC(z.DeepLabV2(21, dtype=dt)),
         lambda: z.MSC(z.DeepLabV2(7, n_blocks=r1), scales=(0.5,)), 65, {}),
        ("beco_r101", lambda dt: z.BECODeepLabV3Plus(21, dtype=dt),
         lambda: z.BECODeepLabV3Plus(7, depth=26), 128, {}),
        ("mmseg_deeplab3", lambda dt: z.MMSegDeepLab3(21, dtype=dt),
         lambda: z.MMSegDeepLab3(7, depth=26), 64, aux),
        ("mmseg_deeplab3p", lambda dt: z.MMSegDeepLab3(21, separable=True, dtype=dt),
         lambda: z.MMSegDeepLab3(7, depth=26, separable=True), 128, aux),
        ("uper_swin_b", lambda dt: z.UPerSwin(21, "swin-b", dtype=dt),
         lambda: z.UPerSwin(7, "swin_tiny_test"), 128, aux),
    ]


def _outputs(out):
    """A family's outputs, the main logits first: MSC's train mode returns
    [logits at each scale, fused], the mmseg models (main, aux)."""
    return out[::-1] if isinstance(out, list) else list(out) if isinstance(out, tuple) else [out]


def phase_zoo(smi: str, root: str):
    """Phase 12, the model zoo on the card. (a) Swin-B ``swinend2end`` at
    full width on phase 8's ShapesWSSS tree with the default RFF energy,
    pretrained from an mmseg-key .pth written here from a model seeded
    apart: 4 steps with a validation and a checkpoint at steps 2 and 4,
    ``finaleval`` of the best-seg weights on the val split with the device
    CRF, and a run resumed from step 2; held: the file's backbone in
    student and teacher before step 1, finite losses and mIoUs, exact
    launch counts (K3 once a step, after the calibration's 2; no K1/K2),
    the resumed losses within 5e-3. (b) Every seg-only family: at its tiny
    test config in f32, the card's eval output within 1e-4 of the same
    module on the CPU; at its published width, batch 2 at 512^2 in bf16,
    one eval-mode and one train-mode forward, finite on the family's grid,
    with the BatchNorm running statistics moved. Returns each run's launch
    counts."""
    import copy
    import shutil
    import time

    import numpy as np
    import torch

    import cosa_tpu_torch.train.loop as loop_mod
    from cosa_tpu_torch.eval.engine import score_names
    from cosa_tpu_torch.models.network import build_model, init_params
    from cosa_tpu_torch.models.zoo.resnet import BatchNorm

    pre = os.path.join(ROOT, "build", "chip_smoke", "pretrained_swin.pth")
    cfg = _optin_cfg(root, name="swin", model="swinend2end", backbone="swin-b",
                     energy_filter="rff", usegmm=False, usepar=False, pretrained_path=pre)
    src = build_model(cfg, "cpu", seed=PRETRAINED_SEED).state_dict()
    torch.save(_mmseg_swin_keys(src), pre)
    out = loop_mod.output_dir(cfg)
    cfg_r = cfg.replace(name="swin_resume", resume=os.path.join(out, "ckpt", "step_00000002.pt"))
    for d in (out, loop_mod.output_dir(cfg_r)):
        shutil.rmtree(d, ignore_errors=True)
    loaded, counts = [], {}

    def checking(load):  # before step 1: both backbones hold the file's weights
        def fn(c, state):
            load(c, state)
            for model in (state.student, state.teacher):
                own = model.state_dict()
                loaded.append(all(torch.equal(own[k].cpu(), v) for k, v in src.items()
                                  if k.startswith("backbone.")))
            return state
        return fn

    def run(tag, fn, **want):
        _reset_counts()
        res = fn()
        torch.cuda.synchronize()
        counts[tag] = _counts()
        if counts[tag] != _want(**want):
            raise AssertionError(f"phase 12 {tag}: launch counts {counts[tag]} != {_want(**want)}")
        return res

    torch.cuda.reset_peak_memory_stats()
    with _patched(loop_mod, "load_pretrained_into_state", checking):
        res = run("swin", lambda: loop_mod.train(cfg, device="cuda"), rff_phi=4 + 2)
    peak = torch.cuda.max_memory_allocated()
    if loaded != [True, True]:
        raise AssertionError(f"phase 12: pretrained backbone in student, teacher: {loaded}")
    recs = res["records"]
    if len(recs) != 4 or not all(math.isfinite(r[k]) for r in recs for k in loop_mod.LOSS_KEYS):
        raise AssertionError(f"phase 12 swin: losses {recs}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        vals = [r for r in map(json.loads, f) if r["kind"] == "val"]
    if [(r["iter"], r["model"]) for r in vals] != [(2, "ON"), (2, "AN"), (4, "ON"), (4, "AN")]:
        raise AssertionError(f"phase 12: validations {vals}")
    for r in vals:
        _check_scores(f"phase 12 validation {r['model']} @ {r['iter']}",
                      {k: v for k, v in r.items() if k not in ("kind", "model", "iter", "wall_s")})
    med = statistics.median(r["itertime"] for r in recs[1:])
    log(f"phase 12 swin ({cfg.backbone}, crop {cfg.crop_size}, batch {cfg.batch_size}, bf16, "
        f"drop path 0.3): sec/iter median {med:.4f} s over steps 2-4 "
        f"({cfg.batch_size / med:.2f} img/s), peak memory {peak / 2 ** 30:.2f} GiB, best seg "
        f"{res['best_seg']:.2f}, last losses "
        f"{json.dumps({k: recs[-1][k] for k in loop_mod.LOSS_KEYS})}, launches "
        f"{counts['swin']}, on {smi}")

    # finaleval scores the run's best-seg weights (a pretrained_path would
    # name the checkpoint to score instead)
    fin = run("swin_finaleval",
              lambda: loop_mod.finaleval(cfg.replace(pretrained_path=""), device="cuda"))
    t = fin["time"]
    _check_scores("phase 12 final eval", {k: fin[k]["miou"] for k in score_names(fin)})
    log(f"phase 12 swin final eval: {t['images']} images, scales {list(cfg.eval_scales)}: "
        f"{t['seconds'] / t['images']:.4f} s/image, CRF {t['crf_seconds'] / t['images']:.4f} "
        f"s/image (device, crf_reduce {cfg.crf_reduce}); mIoU "
        f"{json.dumps({k: round(fin[k]['miou'], 6) for k in score_names(fin)})}, on {smi}")

    resumed = run("swin_resume", lambda: loop_mod.train(cfg_r, device="cuda"), rff_phi=2 + 2)
    if [r["iter"] for r in resumed["records"]] != [3, 4]:
        raise AssertionError(f"phase 12 resume: steps {[r['iter'] for r in resumed['records']]}")
    straight = {r["iter"]: r for r in recs}
    gap = 0.0
    for r in resumed["records"]:
        for k in loop_mod.LOSS_KEYS:
            a, b = r[k], straight[r["iter"]][k]
            if not abs(a - b) <= 5e-3 * abs(b):
                raise AssertionError(f"phase 12 resume: step {r['iter']} {k} {a} vs {b}")
            gap = max(gap, abs(a - b) / abs(b) if b else 0.0)
    log(f"phase 12 swin: resumed steps 3-4 within {gap:.3e} relative of the straight run's "
        f"losses (bound 5e-3)")

    _reset_counts()
    x_tiny = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    x_big = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, 512, 512, 3)).astype(np.float32)).cuda()
    for name, make, tiny, grid, kw in _zoo_families():
        m = tiny()
        init_params(m, torch.Generator().manual_seed(0))
        card = copy.deepcopy(m).cuda()
        with torch.no_grad():
            ref = _outputs(m(torch.from_numpy(x_tiny), **kw))
            got = _outputs(card(torch.from_numpy(x_tiny).cuda(), **kw))
        tiny_err = max(float((g.cpu() - r).abs().max()) for g, r in zip(got, ref))
        if not tiny_err <= 1e-4:
            raise AssertionError(f"phase 12 {name}: tiny config card vs CPU {tiny_err}")
        del m, card
        m = make(torch.bfloat16).cuda()
        init_params(m, torch.Generator(device="cuda").manual_seed(0))
        bns = [b for b in m.modules() if isinstance(b, BatchNorm)]
        before = [b.running_var.clone() for b in bns]
        with torch.no_grad():
            m(x_big, **kw)  # warm-up: cuDNN's choice of algorithms, the allocator
            ms = {}
            for train in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ys = _outputs(m(x_big, train=train, **kw))
                torch.cuda.synchronize()
                ms["train" if train else "eval"] = (time.perf_counter() - t0) * 1e3
                finite = all(bool(torch.isfinite(y).all()) for y in ys)
                if ys[0].shape != (2, grid, grid, 21) or not finite:
                    raise AssertionError(f"phase 12 {name}: output {tuple(ys[0].shape)}, "
                                         f"finite {finite}")
        moved = sum(not torch.equal(b.running_var, v) for b, v in zip(bns, before))
        if moved != len(bns):
            raise AssertionError(f"phase 12 {name}: {moved} of {len(bns)} BatchNorms moved")
        n_params = sum(p.numel() for p in m.parameters())
        log(f"phase 12 {name}: tiny config card vs CPU {tiny_err:.3e} (bound 1e-4); "
            f"published width ({n_params / 1e6:.1f} M params) batch 2 at 512^2 bf16 -> "
            f"({grid}, {grid}, 21): eval {ms['eval']:.2f} ms, train {ms['train']:.2f} ms "
            f"per forward, {len(bns)} BatchNorms moved, on {smi}")
        del m, ys
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts["seg_only"] = _counts()
    if counts["seg_only"] != _want():
        raise AssertionError(f"phase 12 seg-only: launch counts {counts['seg_only']}")
    log("phase 12 ok: Swin-B from its mmseg file, K3 once a step, no K1/K2; validations, "
        "final eval and resume; every seg-only family finite at its published width and "
        "within 1e-4 of the CPU at its tiny config")
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


# phase 13's bounds: the int8 dense on the card against the CPU, in ulps of
# the output dtype (the codes and the int32 product are exact, the rescale
# the same IEEE operations: expected 0); the int8 teacher's TTA CAMs'
# cosine to the bf16 teacher's (the JAX package's own bound,
# tests/test_train_step.py:208-212); the legacy v2 fuse against the live
# one on the same bf16 teacher, both fusing in f32 (the same operations in
# the same order: expected 0). The step's bf16 CAM fuse is read beside it
# and not bound: it rounds the ReLU sum at its magnitude, and a random-init
# CAM's offset is many times its spread, which min-max normalization
# magnifies (0.116 of the range at a small width on the CPU)
INT8_ULPS = 1
INT8_CAM_COS = 0.98
V2_GAP = 1e-5


def _max_ulps(a, b) -> float:
    """The largest |a - b| in units of b's last place in b's dtype."""
    import torch

    mant = {torch.bfloat16: 8, torch.float32: 24}[b.dtype]
    a64, b64 = a.double().cpu(), b.double().cpu()
    tiny = torch.finfo(b.dtype).tiny
    ulp = torch.exp2(torch.floor(torch.log2(b64.abs().clamp_min(tiny))) - (mant - 1))
    return float(((a64 - b64).abs() / ulp).max())


def _int8_dense_vs_cpu():
    """The int8 dense at the 672 TTA scale's qkv and fc1 shapes (8 x 1765
    rows, K 768, N 2304 and 3072, bf16 out) on the card against the
    CPU's plain path: (max ulps, entries that differ) per N."""
    import torch

    from cosa_tpu_torch.models import quant

    g = torch.Generator().manual_seed(13)
    x = torch.randn((8, 1765, 768), generator=g).to(torch.bfloat16)
    out = {}
    for n in (2304, 3072):
        lin = torch.nn.Linear(768, n).requires_grad_(False)
        with torch.no_grad():
            lin.weight.normal_(0.0, 768 ** -0.5, generator=g)
            lin.bias.normal_(0.0, 0.02, generator=g)
        ref = quant.int8_matmul(x, lin, torch.bfloat16)
        got = quant.int8_matmul(x.cuda(), lin.cuda(), torch.bfloat16)
        torch.cuda.synchronize()
        out[n] = (_max_ulps(got, ref), int((got.cpu() != ref).sum()))
        log(f"  int8 dense (14120, 768) x (768, {n}) bf16: card vs CPU max "
            f"{out[n][0]:.0f} ulp, {out[n][1]} of {ref.numel()} entries differ")
    return out


def _int8_runs(smi: str, sec_iter: float, counts: dict):
    """4 steps of the default configuration with the int8 teacher at
    min_size 512 (the 672 scale: 48 int8 products a step) and 0 (every
    scale: 144); exact launch counts as phase 4's."""
    import torch

    from cosa_tpu_torch.models import quant
    from cosa_tpu_torch.train.loop import LOSS_KEYS, train

    for min_size, per_step in ((512, 48), (0, 144)):
        tag = f"int8_min{min_size}"
        cfg = _main_cfg(name=tag, teacher_int8=True, teacher_int8_min_size=min_size,
                        max_iters=4)
        _reset_counts()
        quant.LAUNCHES["int8_mm"] = 0
        res = train(cfg, device="cuda")
        torch.cuda.synchronize()
        counts[tag] = _counts()
        mm = quant.LAUNCHES["int8_mm"]
        want = _want(flash_fwd=48 * 4, flash_bwd=12 * 4, rff_phi=4 + 2)
        if counts[tag] != want or mm != per_step * 4:
            raise AssertionError(f"phase 13 {tag}: launches {counts[tag]}, int8 products "
                                 f"{mm}; want {want}, {per_step * 4}")
        recs = res["records"]
        if len(recs) != 4 or not all(math.isfinite(r[k]) for r in recs for k in LOSS_KEYS):
            raise AssertionError(f"phase 13 {tag}: losses {recs}")
        med = statistics.median(r["itertime"] for r in recs[1:])
        log(f"phase 13 {tag}: sec/iter median {med:.4f} s over steps 2-4 (phase 4's bf16 "
            f"teacher {sec_iter:.4f} s), int8 products {mm}, launches {counts[tag]}, last "
            f"losses {json.dumps({k: recs[-1][k] for k in LOSS_KEYS})}, on {smi}")


def _int8_vs_bf16_step(convention: float):
    """From one state and batch: one step with the bf16 teacher and one
    with the int8 teacher at min_size 512 and 0. Returns, for each int8
    step, the cosine of its TTA CAMs to the bf16 step's and the share of
    pseudo-mask pixels (main and aux head) that differ."""
    import torch

    import cosa_tpu_torch.train.step as step_mod
    from cosa_tpu_torch.data.loader import build_train_loader
    from cosa_tpu_torch.train.state import create_train_state
    from cosa_tpu_torch.train.step import build_train_step

    base = _main_cfg(name="int8_cmp", energy_convention=convention, warmup_iters=-1)
    loader = build_train_loader(base, base.batch_size)
    try:
        batch = next(loader)
    finally:
        loader.close()
    cams, masks = {}, {}
    tta, cam2mask = step_mod.multi_scale_camseg, step_mod.cam2mask
    try:
        for tag, kw in (("bf16", {}), ("min512", dict(teacher_int8=True)),
                        ("min0", dict(teacher_int8=True, teacher_int8_min_size=0))):
            cams[tag], masks[tag] = [], []
            step_mod.multi_scale_camseg = _recording(tta, cams[tag])
            step_mod.cam2mask = _recording(cam2mask, masks[tag])
            cfg = base.replace(**kw)
            state = create_train_state(cfg, "cuda")
            build_train_step(cfg)(state, {k: torch.from_numpy(v).cuda()
                                          for k, v in batch.items()})
            del state
    finally:
        step_mod.multi_scale_camseg, step_mod.cam2mask = tta, cam2mask
    out = {}
    for tag in ("min512", "min0"):
        cos = _cosine(cams[tag][0][0], cams["bf16"][0][0])
        flips = sum(int((a != b).sum()) for a, b in zip(masks[tag], masks["bf16"]))
        pixels = sum(m.numel() for m in masks["bf16"])
        out[tag] = (cos, flips / pixels)
        log(f"phase 13 int8 teacher ({tag}) vs bf16 teacher, one step: TTA CAM cosine "
            f"{cos:.6f}, pseudo-mask pixels that differ {flips} of {pixels} "
            f"({flips / pixels:.4%})")
    return out


def _optimizer_runs(smi: str, counts: dict):
    """3 steps of each of the reference's other optimizers: the logged lr
    equals the backbone group's schedule, finite losses; poly_cls_sgd runs
    with freeze_norm and must leave the student's norms at their init."""
    import torch

    from cosa_tpu_torch.models.network import build_model
    from cosa_tpu_torch.train.loop import LOSS_KEYS, train
    from cosa_tpu_torch.train.optimizer import lr_schedule, param_label

    for kind in ("cos_adamw", "poly_sgd", "poly_cls_sgd"):
        cfg = _main_cfg(name=f"opt_{kind}", optimizer=kind, max_iters=3,
                        freeze_norm=kind == "poly_cls_sgd")
        _reset_counts()
        res = train(cfg, device="cuda")
        torch.cuda.synchronize()
        counts[kind] = _counts()
        want = _want(flash_fwd=48 * 3, flash_bwd=12 * 3, rff_phi=3 + 2)
        if counts[kind] != want:
            raise AssertionError(f"phase 13 {kind}: launches {counts[kind]} != {want}")
        recs = res["records"]
        sched = lr_schedule(cfg, 1.0)
        lrs = [(r["lr"], sched(r["iter"] - 1)) for r in recs]
        if len(recs) != 3 or any(a != b for a, b in lrs) or not all(
                math.isfinite(r[k]) for r in recs for k in LOSS_KEYS):
            raise AssertionError(f"phase 13 {kind}: lr (logged, schedule) {lrs}, {recs}")
        frozen = None
        if cfg.freeze_norm:
            init = build_model(cfg, "cuda", seed=cfg.seed).state_dict()
            own = res["state"].student.state_dict()
            norms = [k for k in own if param_label(k) == "norm"]
            frozen = len(norms)
            if not norms or not all(torch.equal(own[k], init[k]) for k in norms):
                raise AssertionError(f"phase 13 {kind}: freeze_norm moved a norm")
        log(f"phase 13 {kind}: lr {[f'{a:.4e}' for a, _ in lrs]} equal to the schedule, "
            f"losses {[round(r['overall_loss'], 5) for r in recs]}, norms unchanged: "
            f"{frozen if frozen is not None else 'not frozen'}, launches {counts[kind]}, "
            f"on {smi}")


def _legacy_on_the_card(counts: dict):
    """rrm.compute_joint_loss at crop 448 batch 4 (K3 once; the value within
    1e-3 relative of the CPU's plain path) and multi_scale_camseg_v2
    ('max', 'sum') / ('sum', 'sum') on the bf16 ViT-B teacher against the
    live multi_scale_camseg with f32 CAM arithmetic (K1 12 times a scale
    each; within V2_GAP), the step's bf16 CAM fuse read beside it."""
    import numpy as np
    import torch

    from cosa_tpu_torch.data.loader import build_train_loader
    from cosa_tpu_torch.models.network import build_model
    from cosa_tpu_torch.objectives.pseudo import multi_scale_camseg
    from cosa_tpu_torch.objectives.variants import multi_scale_camseg_v2
    from cosa_tpu_torch.ops.image import normalize
    from cosa_tpu_torch.utils import rrm

    cfg = _main_cfg(name="legacy")
    loader = build_train_loader(cfg, cfg.batch_size)
    try:
        batch = next(loader)
    finally:
        loader.close()
    rng = np.random.default_rng(17)
    b, h = cfg.batch_size, cfg.crop_size
    imgs = normalize(torch.from_numpy(batch["simg"]))
    logits = torch.from_numpy(rng.standard_normal((b, h // 16, h // 16, 21)).astype(np.float32))
    label = rng.integers(0, 21, (b, h, h)).astype(np.int32)
    label[:, :40] = 255
    crop = np.zeros((b, h, h), np.float32)
    for i in range(b):
        crop[i, 8 * i:h - 4 * i, 16 * i:h - 8 * i] = 1.0
    args = (imgs, logits, torch.from_numpy(label), torch.from_numpy(crop))
    ref = [float(v) for v in rrm.compute_joint_loss(*args)]
    _reset_counts()
    got = [float(v) for v in rrm.compute_joint_loss(*(t.cuda() for t in args))]
    torch.cuda.synchronize()
    counts["joint_loss"] = _counts()
    rel = [abs(a - r) / abs(r) for a, r in zip(got, ref)]
    log(f"phase 13 rrm.compute_joint_loss (4, 448, 448): card (ce, dloss) {got}, CPU {ref}, "
        f"relative gaps {[f'{x:.2e}' for x in rel]}, launches {counts['joint_loss']}")
    if counts["joint_loss"] != _want(rff_phi=1) or not max(rel) <= 1e-3:
        raise AssertionError(f"phase 13 joint loss: {counts['joint_loss']}, gaps {rel}")

    teacher = build_model(cfg, "cuda").eval()
    wimg = normalize(torch.from_numpy(batch["wimg"]).cuda(), dtype=torch.bfloat16)
    fuse = {}
    with torch.no_grad():
        for tag, fn in (
                ("live", lambda: multi_scale_camseg(teacher, wimg, cfg.pseudo_scales)),
                ("live_bf16", lambda: multi_scale_camseg(teacher, wimg, cfg.pseudo_scales,
                                                         cam_dtype=torch.bfloat16)),
                ("v2", lambda: multi_scale_camseg_v2(teacher, wimg, cfg.pseudo_scales,
                                                     cam_fuse=("max", "sum"),
                                                     seg_fuse=("sum", "sum")))):
            _reset_counts()
            fuse[tag] = fn()
            torch.cuda.synchronize()
            counts[f"tta_{tag}"] = _counts()

    def gaps(tag):  # cam, cam_aux: max abs on [0, 1]; seg: of its range
        g = [float((a.float() - r.float()).abs().max()) for a, r in zip(fuse["v2"], fuse[tag])]
        return g[0], g[1], g[2] / float(fuse[tag][2].abs().max())

    g, g16 = gaps("live"), gaps("live_bf16")
    log(f"phase 13 multi_scale_camseg_v2 vs the live fuse on the bf16 ViT-B teacher: max gap "
        f"cam {g[0]:.3e}, cam_aux {g[1]:.3e}, seg {g[2]:.3e} of its range (bound {V2_GAP}); "
        f"against the step's bf16 CAM fuse: cam {g16[0]:.3e}, cam_aux {g16[1]:.3e}, seg "
        f"{g16[2]:.3e}; launches {json.dumps({t: counts[f'tta_{t}'] for t in fuse})}")
    want = _want(flash_fwd=12 * len(cfg.pseudo_scales))
    if any(counts[f"tta_{t}"] != want for t in fuse):
        raise AssertionError(f"phase 13 TTA launches {counts}")
    if not max(g) <= V2_GAP:
        raise AssertionError(f"phase 13 v2 vs live: gaps {g}")


def phase_int8_optim_legacy(smi: str, sec_iter: float, convention: float):
    """Phase 13: the int8 teacher, the three other optimizers and the legacy
    surface at the main path's width. Returns the int8 and optimizer runs'
    launch counts and the legacy calls'."""
    import torch

    from cosa_tpu_torch.cli import microbench_int8

    dense = _int8_dense_vs_cpu()
    if not max(u for u, _ in dense.values()) <= INT8_ULPS:
        raise AssertionError(f"phase 13 int8 dense card vs CPU: {dense}")
    rows = microbench_int8.run()
    torch.cuda.synchronize()
    for r in rows:
        if not (math.isfinite(r["ms"]) and r["ms"] > 0):
            raise AssertionError(f"phase 13 microbench_int8: {r}")
        log(f"  int8 microbench {r['case']} {r['path']}: {r['ms']:.4f} ms, "
            f"{r['tflops']:.1f} T(FL)OP/s, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_ms'] / r['ms']:.3f} of it), on {smi}")
    int8 = {}
    _int8_runs(smi, sec_iter, int8)
    cmp = _int8_vs_bf16_step(convention)
    if not min(c for c, _ in cmp.values()) > INT8_CAM_COS:
        raise AssertionError(f"phase 13 int8 vs bf16 teacher CAM cosine: {cmp}")
    _optimizer_runs(smi, int8)
    legacy = {}
    _legacy_on_the_card(legacy)
    log(f"phase 13 ok: int8 dense within {INT8_ULPS} ulp of the CPU "
        f"({json.dumps({n: u for n, (u, _) in dense.items()})}), int8 teacher trains at "
        f"min_size 512 and 0 with the default launches, CAM cosine > {INT8_CAM_COS} "
        f"({json.dumps({t: round(c, 6) for t, (c, _) in cmp.items()})}), the three "
        "optimizers log their schedules, the legacy calls on the card")
    return int8, legacy


# phase 14: val images per validation, the bounds on the dp / tp runs'
# parameter updates and first moments against one process's in norm, the
# validations' bounds, and the tensor-parallel K1 shapes (ViT-B's 12 heads
# over 2 model ranks: 6 per rank)
P14_VAL = 4
# AdamW's first updates move each element by about lr whatever its
# gradient's size, so where a gradient is rounding noise two runs that
# round differently disagree by up to 2 lr; tp's row-parallel bf16 partial
# sums round more of them apart than dp's batch split does. The first
# moments after 2 steps (0.09 g1 + 0.1 g2, whatever the lr) are the
# gradients themselves. Each bound lies between a sound run's reading and
# a broken one's on an H100 80GB HBM3 at 700 W: update dp 6.7e-3 / tp
# 0.184, moments dp 2.7e-3 / tp 0.058; with no data-group gradient average
# the dp update 0.734 and moments 0.453, with copy-to-tp's backward
# all-reduce left out the tp update 0.682 and moments 0.591
P14_UPDATE_REL = {"dp2": 0.05, "tp2": 0.3}
P14_MOMENT_REL = {"dp2": 0.05, "tp2": 0.2}
# the bound on a validation's mIoU against a one-process evaluate of the
# same weights: dp's ranks run each image's arithmetic unchanged (equal
# scores expected); tp's row-parallel products round each rank's bf16
# partial sum once more than the one-process product, which flips the
# pixels that sit at a threshold or an argmax tie (a CPU rehearsal at
# vit_small / crop 64 read a 5.9e-3 gap)
P14_MIOU = {"dp2": 1e-4, "tp2": 2e-2}
P14_K1 = ((48, 785), (48, 197), (48, 1765), (24, 785))


def _p14_batches(cfg, dp: int, steps: int):
    """The global batches of a run of ``cfg`` over ``dp`` data ranks: each
    rank's loader shard, its rows side by side in rank order."""
    import numpy as np

    from cosa_tpu_torch.data.loader import build_train_loader

    loaders = [build_train_loader(cfg, cfg.batch_size, process_index=r, process_count=dp)
               for r in range(dp)]
    try:
        per = [[next(ld) for _ in range(steps)] for ld in loaders]
    finally:
        for ld in loaders:
            ld.close()
    return [{k: np.concatenate([p[i][k] for p in per]) for k in per[0][i]}
            for i in range(steps)]


def _p14_moments(state):
    """The student's AdamW first moments, flat in parameter order (zero
    where the optimizer holds none)."""
    import torch

    st = state.optimizer.opt.state
    return torch.cat([st[p]["exp_avg"].reshape(-1) if "exp_avg" in st.get(p, {})
                      else torch.zeros(p.numel(), device=p.device)
                      for p in state.student.parameters()])


def _p14_reference(cfg, batches, resume=None):
    """One process at the global batch, from the seeded init or from the
    checkpoint ``resume``: the losses of each step, the student's
    parameters before the first step and after the second, and its first
    moments after the second."""
    import torch

    from cosa_tpu_torch.train import checkpoint as ckpt
    from cosa_tpu_torch.train.loop import LOSS_KEYS, to_device
    from cosa_tpu_torch.train.state import create_train_state
    from cosa_tpu_torch.train.step import build_train_step

    state = create_train_state(cfg, "cuda")
    if resume:
        ckpt.restore_state(resume, state)
    p0 = torch.cat([p.detach().reshape(-1) for p in state.student.parameters()])
    step = build_train_step(cfg)
    losses, p2, m2 = [], None, None
    for i, b in enumerate(batches):
        m = step(state, to_device(b, torch.device("cuda")))
        losses.append({k: float(m[k]) for k in LOSS_KEYS})
        if i == 1:
            p2 = torch.cat([p.detach().reshape(-1) for p in state.student.parameters()])
            m2 = _p14_moments(state)
    return losses, p0, p2, m2


def _p14_compare(tag, runs, ref_losses, first_iter, want):
    """Each rank's run (``runs``, in rank order): its logged losses against
    the one-process losses (5e-3 relative, phase 5's bound) and equal to
    rank 0's, its launches equal to ``want``. Returns the largest gap."""
    from cosa_tpu_torch.train.loop import LOSS_KEYS

    gap = 0.0
    for rank, run in enumerate(runs):
        if run["launches"] != want:
            raise AssertionError(f"phase 14 {tag} rank {rank}: launches {run['launches']} "
                                 f"!= {want}")
        recs = run["records"]
        if [r["iter"] for r in recs] != list(range(first_iter, first_iter + len(recs))):
            raise AssertionError(f"phase 14 {tag}: steps {[r['iter'] for r in recs]}")
        for r, r0 in zip(recs, runs[0]["records"]):
            ref = ref_losses[r["iter"] - 1]
            for k in LOSS_KEYS:
                if not abs(r[k] - ref[k]) <= 5e-3 * abs(ref[k]) or r[k] != r0[k]:
                    raise AssertionError(f"phase 14 {tag} rank {rank} step {r['iter']} {k}: "
                                         f"{r[k]} vs one process {ref[k]}, rank 0 {r0[k]}")
                gap = max(gap, abs(r[k] - ref[k]) / abs(ref[k]) if ref[k] else 0.0)
    return gap


def _p14_checkpoint(tag, cfg, path, p0, p2, m2, results):
    """The run's step-2 checkpoint read by one process: its student's update
    and first moments against the one-process run's in norm, and its
    student and teacher scored by a one-process evaluate against the run's
    own validation (every mIoU within ``P14_MIOU[tag]``; whether every
    score is equal is printed)."""
    import numpy as np
    import torch

    from cosa_tpu_torch.data.loader import build_val_dataset
    from cosa_tpu_torch.eval.engine import evaluate, score_names
    from cosa_tpu_torch.train import checkpoint as ckpt
    from cosa_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, "cuda")
    ckpt.restore_state(path, state)
    pk = torch.cat([p.detach().reshape(-1) for p in state.student.parameters()])
    rel = float(torch.linalg.vector_norm((pk - p0) - (p2 - p0))
                / torch.linalg.vector_norm(p2 - p0))
    rel_m = float(torch.linalg.vector_norm(_p14_moments(state) - m2)
                  / torch.linalg.vector_norm(m2))
    log(f"phase 14 {tag}: the student's update {rel:.4e} and first moments {rel_m:.4e} "
        "off one process's in norm")
    if not (rel < P14_UPDATE_REL[tag] and rel_m < P14_MOMENT_REL[tag]):
        raise AssertionError(f"phase 14 {tag}: update {rel:.3e} (bound {P14_UPDATE_REL[tag]}), "
                             f"first moments {rel_m:.3e} (bound {P14_MOMENT_REL[tag]})")
    val = build_val_dataset(cfg)
    worst, equal = 0.0, True
    for who in ("student", "teacher"):
        ref = evaluate(cfg, getattr(state, who), val, max_images=cfg.fasteval_n,
                       threshold_filters=cfg.eval_threshold_filters, device="cuda")
        got = results[who]
        for k in score_names(ref):
            try:
                np.testing.assert_equal(got[k], ref[k])
            except AssertionError:
                equal = False
            worst = max(worst, abs(got[k]["miou"] - ref[k]["miou"]))
        if got["cls_aps"] != ref["cls_aps"]:
            equal = False
    if worst > P14_MIOU[tag]:
        raise AssertionError(f"phase 14 {tag}: validation vs one-process evaluate: equal "
                             f"{equal}, largest mIoU gap {worst}")
    del state
    torch.cuda.empty_cache()
    return rel, rel_m, equal, worst


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_parallel(smi: str, sec_iter: float, convention: float):
    """Phase 14, multi-process runs of the main path (ViT-B/16 + LargeFOV,
    crop 448, bf16, RFF energy, validations of 4 images at eval_batch 1):
    (a) dp = 2 on the one card over gloo, batch 2 per rank, through
    train.loop.train: 2 steps with a validation and a checkpoint at step
    2, then a run resumed from it for step 3; (b) tp = 2 on the one card
    over gloo, batch 4, 2 steps and a validation; each against one process
    at the same global batches (losses within 5e-3 relative, step 3 from
    the same checkpoint; the student's update and first moments in norm;
    the run's validation against a one-process evaluate of its step-2
    checkpoint; exact launches per rank), and K1 at tp=2's local head
    count against its plain version; (c) NCCL at world size 1
    through torch.distributed.run and the training CLI; (d) dp = 2 over
    NCCL, one card per rank, where there are two cards. Also the gloo
    all-reduce of the student's gradient on the card, timed alone.
    Returns rank 0's launches of each leg."""
    import shutil

    import torch
    import torch.nn.functional as F

    from cosa_tpu_torch.kernels import flash
    from cosa_tpu_torch.parallel.launch import allreduce_worker, spawn, train_worker
    from cosa_tpu_torch.train.loop import output_dir

    def cfg_of(**kw):
        return _main_cfg(max_iters=2, eval_iters=2, fasteval=True, fasteval_n=P14_VAL,
                         eval_batch=1, energy_convention=convention, checkpoint_keep=2,
                         **kw)

    ref_cfg = cfg_of(name="p14_ref")
    per_val = 12 * len(ref_cfg.eval_scales)  # K1 per image per model

    def want(steps, images):
        return dict(flash_fwd=48 * steps + 2 * images * per_val, flash_bwd=12 * steps,
                    rff_phi=steps)

    launches, secs = {}, {}

    # (a) dp = 2 over gloo on one card
    cfg_a = cfg_of(name="p14_dp2", batch_size=2, dp=2)
    ck_a = os.path.join(output_dir(cfg_a), "ckpt", "step_00000002.pt")
    cfg_a2 = cfg_a.replace(name="p14_dp2_resumed", max_iters=3, resume=ck_a)
    for c in (cfg_a, cfg_a2):
        shutil.rmtree(output_dir(c), ignore_errors=True)
    t0 = time.time()
    outs = spawn(train_worker, 2, [cfg_a, cfg_a2], "cuda:0")
    wall_a = time.time() - t0
    batches = _p14_batches(cfg_a, 2, 3)
    ref_losses, p0, p2, m2 = _p14_reference(ref_cfg, batches[:2])
    # step 3 from the run's own step-2 checkpoint: two runs that start
    # apart by rounding drift further apart at a real lr
    ref_losses += _p14_reference(ref_cfg, batches[2:], resume=ck_a)[0]
    n_params = p0.numel()
    local = P14_VAL // 2  # each data rank's validation images
    gap = max(_p14_compare("dp2", [o[0] for o in outs], ref_losses, 1, _want(**want(2, local))),
              _p14_compare("dp2 resumed", [o[1] for o in outs], ref_losses, 3,
                           _want(**want(1, 0))))
    rel_a, mom_a, eq_a, worst_a = _p14_checkpoint("dp2", ref_cfg, ck_a, p0, p2, m2,
                                                  outs[0][0]["results"])
    launches["dp2"] = {k: outs[0][0]["launches"][k] + outs[0][1]["launches"][k]
                       for k in outs[0][0]["launches"]}
    secs["dp2"] = statistics.median([outs[0][0]["records"][1]["itertime"],
                                     outs[0][1]["records"][0]["itertime"]])
    log(f"phase 14 (a) dp=2 gloo, one card: losses within {gap:.3e} of one process at the "
        f"global batch 4 over steps 1-2 and, resumed at 2, step 3, student update {rel_a:.3e} "
        f"and first moments {mom_a:.3e} off in norm, validation equal to one process's: "
        f"{eq_a} (largest mIoU gap {worst_a}), launches per rank exact; {wall_a:.1f} s for "
        "both runs")
    del p0, p2, m2

    # (b) tp = 2 over gloo on one card
    cfg_b = cfg_of(name="p14_tp2", batch_size=4, tp=2)
    shutil.rmtree(output_dir(cfg_b), ignore_errors=True)
    t0 = time.time()
    outs_b = spawn(train_worker, 2, [cfg_b], "cuda:0")
    wall_b = time.time() - t0
    ref_losses, p0, p2, m2 = _p14_reference(ref_cfg, _p14_batches(cfg_b, 1, 2))
    gap_b = _p14_compare("tp2", [o[0] for o in outs_b], ref_losses, 1,
                         _want(**want(2, P14_VAL)))
    rel_b, mom_b, eq_b, worst_b = _p14_checkpoint(
        "tp2", ref_cfg, os.path.join(output_dir(cfg_b), "ckpt", "step_00000002.pt"),
        p0, p2, m2, outs_b[0][0]["results"])
    launches["tp2"] = outs_b[0][0]["launches"]
    secs["tp2"] = outs_b[0][0]["records"][1]["itertime"]
    del p0, p2, m2
    gen = torch.Generator(device="cuda").manual_seed(14)
    scale = 64 ** -0.5
    k1 = []
    for bh, n in P14_K1:
        qkv = _qkv(bh // 6, n, 6, gen)
        q, k, v = _split(qkv, 6)
        ref = flash.plain_attention(q, k, v, scale).reshape(bh // 6, n, 6 * 64)
        o, _ = flash.attn_fwd(qkv, 6, scale)
        torch.cuda.synchronize()
        err = float((o.float() - ref).abs().max())
        ms = time_ms(lambda: flash.attn_fwd(qkv, 6, scale))
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        plain = time_ms(lambda: flash.plain_attention(qb, kb, vb, scale))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (qb, kb, vb))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        bms, by = bound_ms(4.0 * bh * n * 64 * 2 + bh * n * 4, 4.0 * bh * n * n * 64, PEAK_BF16)
        k1.append(f"({bh}, {n}) err {err:.3e} {ms:.4f} ms (plain {plain:.4f}, sdpa "
                  f"{lib:.4f}, bound {bms:.4f} by {by})")
        if not err < 5e-3:
            raise AssertionError(f"phase 14 K1 at tp=2 (B*H={bh}, N={n}): {err}")
        del qkv, q, k, v, ref, o, qb, kb, vb, qh, kh, vh
    log(f"phase 14 (b) tp=2 gloo, one card: losses within {gap_b:.3e} of one process, "
        f"student update {rel_b:.3e} and first moments {mom_b:.3e} off in norm, validation within {worst_b} mIoU of one "
        f"process's (equal: {eq_b}), launches per rank exact; {wall_b:.1f} s; K1 at 6 "
        f"local heads vs plain: {'; '.join(k1)}")

    # the gradient all-reduce over gloo on the card, alone
    ar = spawn(allreduce_worker, 2, n_params, "cuda:0")[0]
    log(f"phase 14 gloo all-reduce of the student's {n_params} f32 on cuda:0, 2 ranks on "
        f"one card (staged through the host): {ar['ms']:.1f} ms on {smi}")

    # (c) NCCL at world size 1 through torch.distributed.run and the CLI
    cfg_c = _main_cfg(name="p14_nccl1", max_iters=2)
    shutil.rmtree(output_dir(cfg_c), ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=1",
           f"--master_port={_free_port()}", "-m", "cosa_tpu_torch.cli.train", cfg_c.name,
           "--dataset", "synthetic", "--backbone", cfg_c.backbone, "--crop_size",
           str(cfg_c.crop_size), "--batch_size", str(cfg_c.batch_size), "--max_iters", "2",
           "--eval_iters", str(10 ** 9), "--log_iters", "1", "--warmup_iters", "2",
           "--lr_warmup_iters", "2", "--finalval", "false", "--pretrained", "false",
           "--energy_convention", repr(convention), "--work_dir", cfg_c.work_dir]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    wall_c = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 14 (c) torchrun exit {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(output_dir(cfg_c), "metrics.jsonl")) as f:
        recs_c = [r for r in map(json.loads, f) if r["kind"] == "train"]
    with open(os.path.join(output_dir(cfg_c), "print.out")) as f:
        printed = f.read()
    if [r["iter"] for r in recs_c] != [1, 2] or "(1 processes)" not in printed:
        raise AssertionError(f"phase 14 (c): records {recs_c}, print.out {printed[-500:]}")
    secs["nccl1"] = recs_c[1]["itertime"]
    log(f"phase 14 (c) NCCL world 1 via torch.distributed.run + cli.train: 2 steps logged "
        f"by rank 0, {wall_c:.1f} s for the command")

    # (d) NCCL across cards
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cfg_d = cfg_of(name="p14_nccl_dp2", batch_size=2, dp=2)
        shutil.rmtree(output_dir(cfg_d), ignore_errors=True)
        outs_d = spawn(train_worker, 2, [cfg_d], None, backend="nccl")
        ref_d = _p14_reference(ref_cfg, _p14_batches(cfg_d, 2, 2))[0]
        gap_d = _p14_compare("nccl dp2", [o[0] for o in outs_d], ref_d, 1,
                             _want(**want(2, local)))
        launches["nccl_dp2"] = outs_d[0][0]["launches"]
        secs["nccl_dp2"] = outs_d[0][0]["records"][1]["itertime"]
        log(f"phase 14 (d) dp=2 over NCCL on 2 cards: losses within {gap_d:.3e} of one "
            "process, launches per rank exact")
    else:
        log(f"phase 14 (d) NCCL across cards did not run: torch.cuda.device_count() = "
            f"{n_cards}, it needs 2")
    log(f"phase 14 ok: sec/iter {json.dumps({k: round(v, 4) for k, v in secs.items()})} "
        f"beside phase 4's {sec_iter:.4f} (one process, batch 4) on {smi}; a step of "
        f"global batch 4 in each")
    return launches

# phase 15: the synthrun preset's run on phase 8's tree, and the panels
# report_synth dumps
P15_STEPS, P15_EVAL, P15_PANELS = 40, 20, 2


def phase_runs(smi: str, out8: str, cfg8):
    """Phase 15, on phase 8's ShapesWSSS tree: the ``synthrun`` preset of
    cli/run_synth.py at full width (ViT-B/16 at 448, batch 4, bf16, from
    scratch) for 40 steps with validations at 20 and 40 and finaleval with
    the device CRF; report_synth on its output with 2 panels; parity_voc on
    phase 8's best-seg weights, its table held to finaleval's result on
    those weights and its exit code to the one that table implies. Exact
    launch counts for each. Returns each run's counts."""
    import contextlib
    import io
    import shutil

    import torch

    import cosa_tpu_torch.train.loop as loop_mod
    from cosa_tpu_torch.cli import parity_voc, report_synth, run_synth
    from cosa_tpu_torch.config import diff_from_preset, parse_cli, preset_config
    from cosa_tpu_torch.data.datasets import VOC_CLASSES
    from cosa_tpu_torch.data.loader import build_val_dataset
    from cosa_tpu_torch.eval.engine import score_names

    root, work = cfg8.data_root, cfg8.work_dir
    argv = ["synthrun", "p15_synthrun", "--data_root", root, "--split_dir", cfg8.split_dir,
            "--max_iters", str(P15_STEPS), "--eval_iters", str(P15_EVAL),
            "--finalval", "true", "--work_dir", work]
    cfg = parse_cli(run_synth.train_argv(argv[0], argv[1], argv[2:]))
    out = loop_mod.output_dir(cfg)
    n_val = len(build_val_dataset(cfg))
    per_batch = 12 * len(cfg.eval_scales)  # K1 per eval batch: 12 blocks at each scale
    val_k1 = -(-n_val // cfg.eval_batch) * per_batch  # one network on the val split
    counts = {}

    def run(tag, fn, **want):
        _reset_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            res = fn()
        torch.cuda.synchronize()
        counts[tag] = _counts()
        if counts[tag] != _want(**want):
            raise AssertionError(f"phase 15 {tag}: launch counts {counts[tag]} != {_want(**want)}")
        return res, text.getvalue(), time.time() - t0

    shutil.rmtree(out, ignore_errors=True)
    n_vals = P15_STEPS // P15_EVAL
    _, _, secs = run("synthrun", lambda: run_synth.main(argv),
                     flash_fwd=48 * P15_STEPS + 2 * n_vals * val_k1 + val_k1,
                     flash_bwd=12 * P15_STEPS, rff_phi=P15_STEPS + 2)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    trains = [r for r in recs if r["kind"] == "train"]
    vals = [r for r in recs if r["kind"] == "val"]
    final = [r for r in recs if r["kind"] == "final"]
    its = list(range(P15_EVAL, P15_STEPS + 1, P15_EVAL))
    if [r["iter"] for r in trains] != its or \
            [(r["iter"], r["model"]) for r in vals] != [(i, m) for i in its for m in ("ON", "AN")] \
            or len(final) != 1:
        raise AssertionError(f"phase 15 synthrun: records {[(r['kind'], r.get('iter')) for r in recs]}")
    for r in trains:
        if not all(math.isfinite(r[k]) for k in loop_mod.LOSS_KEYS):
            raise AssertionError(f"phase 15 synthrun: non-finite loss {r}")
    for r in vals + final:
        _check_scores(f"phase 15 synthrun {r['kind']} {r.get('model', '')}",
                      {k: v for k, v in r.items() if k in ("CAM", "aux_CAM", "Seg_ps", "Seg_vd",
                                                         "Seg_crf")})
    with open(os.path.join(out, "print.out")) as f:
        printed = f.read()
    with open(os.path.join(out, "log_val.txt")) as f:
        first_val = f.readline().strip()
    want_diff = {"pretrained": False, "lr": 3e-4, "warmup_iters": 1500, "lr_warmup_iters": 500,
                 "warmup_gate_floor": 0.01, "batch_size": 4, "max_iters": P15_STEPS,
                 "eval_iters": P15_EVAL}
    diff = diff_from_preset(cfg)
    if any(diff.get(k) != v for k, v in want_diff.items()) or \
            not printed.startswith(f"config diff vs VOC12 preset: {diff}") or \
            "Final Model Result" not in printed or first_val != f"iters:{P15_EVAL - 1}" or \
            not os.path.exists(os.path.join(out, "best_seg", "params.pt")):
        raise AssertionError(f"phase 15 synthrun: config {diff}, logs {printed[:200]!r}, "
                             f"log_val {first_val!r}")
    conv = [ln for ln in printed.splitlines() if ln.startswith("energy convention")]
    log(f"phase 15 synthrun preset: {P15_STEPS} steps, validations at {its}, finaleval "
        f"Seg_vd {final[0]['Seg_vd']:.4f} Seg_crf {final[0]['Seg_crf']:.4f}, {secs:.1f} s, "
        f"sec/iter {[round(r['itertime'], 4) for r in trains]}; {conv[0] if conv else ''}; "
        f"launches {counts['synthrun']}, on {smi}")

    panels = os.path.join(out, "qualitative")
    _, text, secs = run("report_synth", lambda: report_synth.main(
        ["--out_dir", out, "--data_root", root, "--split_dir", cfg.split_dir,
         "--panels", str(P15_PANELS)]),
        flash_fwd=-(-P15_PANELS // cfg.eval_batch) * per_batch)
    rows = [f"| {i} | {100 * v['ON']['CAM']:.1f} | {100 * v['ON']['Seg_vd']:.1f} | "
            f"{100 * v['AN']['CAM']:.1f} | {100 * v['AN']['Seg_vd']:.1f} |"
            for i, v in ((i, {r["model"]: r for r in vals if r["iter"] == i}) for i in its)]
    seg_pngs = os.listdir(os.path.join(panels, "seg"))
    if not all(row in text.splitlines() for row in rows) or "Best val" not in text or \
            "Final Model Result" not in text or len(seg_pngs) != P15_PANELS:
        raise AssertionError(f"phase 15 report_synth: {text!r}, panels {seg_pngs}")
    log(f"phase 15 report_synth: the trajectory rows {rows}, {len(seg_pngs)} panels, "
        f"{secs:.1f} s, launches {counts['report_synth']}")

    weights = os.path.join(out8, "best_seg", "params.pt")
    shutil.rmtree(os.path.join(work, "parity_voc"), ignore_errors=True)
    rc, text, secs = run("parity_voc", lambda: parity_voc.main(
        [weights, "--voc_root", root, "--split_dir", cfg8.split_dir, "--work_dir", work]),
        flash_fwd=val_k1)
    ref_cfg = preset_config("VOC12", name="p15_parity_ref", work_dir=work, data_root=root,
                            split_dir=cfg8.split_dir, pretrained_path=weights)
    shutil.rmtree(loop_mod.output_dir(ref_cfg), ignore_errors=True)
    ref, _, _ = run("parity_ref", lambda: loop_mod.finaleval(ref_cfg, device="cuda"),
                    flash_fwd=val_k1)
    _check_scores("phase 15 parity reference", {k: ref[k]["miou"] for k in score_names(ref)})
    with open(parity_voc.EXPECTED) as f:
        expected = json.load(f)
    lines, want_rc = text.splitlines(), 0
    for fam in ("Seg_vd", "Seg_crf"):
        names = [(n, ref[fam]["iou"][i], expected[fam][n], 1.0) for i, n in enumerate(VOC_CLASSES)]
        for name, iou, exp, tol in names + [("mIoU", ref[fam]["miou"], expected[fam]["mIoU"], 0.5)]:
            ours = 100.0 * float(iou)
            if not any(ln.startswith(f"{name:14s} {ours:7.2f}  ref {exp:7.2f}") for ln in lines):
                raise AssertionError(f"phase 15 parity_voc {fam} {name}: {ours:.2f} not in "
                                     f"{text!r}")
            want_rc |= int(abs(ours - exp) > tol)
    if rc != want_rc:
        raise AssertionError(f"phase 15 parity_voc: exit code {rc}, the table implies {want_rc}")
    log(f"phase 15 parity_voc: phase 8's best-seg weights on {n_val} val images, the table "
        f"equal to finaleval's (Seg_vd {ref['Seg_vd']['miou']:.4f}, Seg_crf "
        f"{ref['Seg_crf']['miou']:.4f}), exit code {rc} as the table implies, {secs:.1f} s; "
        f"launches {counts['parity_voc']}")
    log("phase 15 ok: the synthrun preset trains, validates and scores with exact launches; "
        "report_synth prints its trajectory and dumps the panels; parity_voc's table and exit "
        "code agree with finaleval")
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
    phase_opt_in_ops(smi)
    counts, convention, sec_iter = phase_main_path(smi)
    phase_flash_vs_plain(convention)
    scoring, device_time = phase_scoring(smi)
    mb_counts = phase_microbench()
    optin, out, cfg = phase_optin(smi)
    optin.update(phase_host_crf(smi, out, cfg, device_time))
    pseudo = phase_pseudo_submission(smi, out, cfg)
    variants = phase_variants(smi, cfg.data_root)
    zoo = phase_zoo(smi, cfg.data_root)
    int8, legacy = phase_int8_optim_legacy(smi, sec_iter, convention)
    parallel = phase_parallel(smi, sec_iter, convention)
    presets = phase_runs(smi, out, cfg)
    for r in rows:
        # launches on the kernel's own path: training for K1-K3, the
        # microbenchmark for K4; the other paths' runs beside them
        r["launches"] = (mb_counts if r["name"].startswith("flash_fwd_") else counts)[r["name"]]
        for key, runs in (("scoring", scoring), ("optin", optin), ("pseudo", pseudo),
                          ("variant", variants), ("zoo", zoo), ("int8", int8),
                          ("legacy", legacy), ("parallel", parallel), ("runs", presets)):
            r[f"{key}_launches"] = {tag: c[r["name"]] for tag, c in runs.items()}
        r["ok"] = True
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
