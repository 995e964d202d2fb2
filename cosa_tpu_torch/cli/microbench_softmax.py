"""Microbenchmark: K1's forward against its two softmax variants (K4).

The port's counterpart of scripts/microbench_softmax.py. At the teacher's
training shapes (B*H = 96, head dim 64, N = 785 and 1765 tokens; bf16 inputs
from a seeded generator, scale 1/8) it times, with CUDA events:

  * prod:    K1, the shipped forward (kernels/flash.py, f32 exp2 softmax);
  * bf16exp: K4 with exp2 on bf16 pairs (ex2.approx.ftz.bf16x2 on Hopper);
  * nomax:   K4 with a fixed shift of 30 in place of the row max.

It prints one JSON line per (n, variant) with the JAX script's keys: ``n``,
``variant``, ``ms`` and ``cos_vs_prod``, the cosine between the variant's
output and K1's. It runs on the GPU only:

    python -m cosa_tpu_torch.cli.microbench_softmax
"""

from __future__ import annotations

import json
from typing import Dict, List

import torch

from cosa_tpu_torch.kernels import flash, flash_variants
from cosa_tpu_torch.utils.device import resolve_device

BATCH, HEADS = 8, 12  # B*H = 96
TOKENS = (785, 1765)
SCALE = 1 / 8.0
REPS, WARMUP = 30, 3


def time_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` back-to-back
    calls, between two CUDA events."""
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


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().reshape(-1), b.float().reshape(-1)
    return float(torch.dot(a, b) / (torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)))


def run(seed: int = 0) -> List[Dict]:
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for n in TOKENS:
        qkv = torch.randn((BATCH, n, 3 * HEADS * 64), generator=gen, device=dev)
        qkv = qkv.to(torch.bfloat16)
        runs = {"prod": lambda: flash.attn_fwd(qkv, HEADS, SCALE)[0]}
        for mode in flash_variants.MODES:
            runs[mode] = (lambda m=mode: flash_variants.attn_fwd_variant(
                qkv, HEADS, SCALE, None, m))
        ref = runs["prod"]()
        for name, fn in runs.items():
            cos = cosine(fn(), ref)
            rows.append(dict(n=n, variant=name, ms=time_ms(fn), cos_vs_prod=cos))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> None:
    run()


if __name__ == "__main__":
    main()
