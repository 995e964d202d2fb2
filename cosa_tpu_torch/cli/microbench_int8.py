"""Microbenchmark: the int8 teacher's dense product against bf16.

The port's counterpart of scripts/microbench_int8.py. At the ViT-B MLP's
fc1 (K 768, N 3072) for the teacher's two large TTA batches, 8 images at
448^2 (785 tokens) and at 672^2 (1765 tokens), it times with CUDA events:

  * bf16:     the bf16 product with f32 accumulation (the default teacher);
  * int8_raw: the int8 product into int32 alone (``torch._int_mm``);
  * int8_e2e: models/quant.py::int8_matmul, the teacher's int8 path: the
    activations' per-row and the f32 weight's per-channel quantize, the int8
    product, rescale, bias, the cast to bf16 (the JAX script quantizes the
    activations only).

It prints one JSON line per case with the JAX script's keys (``case``,
``path``, ``ms``, ``tflops``: TOP/s for int8) and the least time of the
same operations at the H100 SXM's dense peak beside it, 989 TFLOP/s bf16
and 1979 TOP/s int8 (``bound_ms``). It runs on the GPU only:

    python -m cosa_tpu_torch.cli.microbench_int8
"""

from __future__ import annotations

import json
from typing import Dict, List

import torch

from cosa_tpu_torch.cli.microbench_softmax import time_ms
from cosa_tpu_torch.models.quant import int8_matmul, int_mm
from cosa_tpu_torch.utils.device import resolve_device

# (tokens, tag): 8 images at the 448 and 672 TTA scales
SHAPES = ((8 * 785, "448"), (8 * 1765, "672"))
K, N = 768, 3072
PEAK = {"bf16": 989e12, "int8_raw": 1979e12, "int8_e2e": 1979e12}


def run(seed: int = 0) -> List[Dict]:
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    layer = torch.nn.Linear(K, N).to(dev)
    with torch.no_grad():
        layer.weight.normal_(0.0, K ** -0.5, generator=gen)
        layer.bias.normal_(0.0, 0.02, generator=gen)
    w16 = layer.weight.t().to(torch.bfloat16)
    w8 = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8).t()
    rows = []
    for m, tag in SHAPES:
        x = torch.randn((m, K), generator=gen, device=dev).to(torch.bfloat16)
        x8 = torch.randint(-127, 128, (m, K), generator=gen, device=dev, dtype=torch.int8)
        runs = {
            "bf16": lambda: torch.matmul(x, w16),
            "int8_raw": lambda: int_mm(x8, w8),
            "int8_e2e": lambda: int8_matmul(x, layer, torch.bfloat16),
        }
        ops = 2.0 * m * K * N
        for path, fn in runs.items():
            ms = time_ms(fn)
            rows.append(dict(case=f"mlp_fc1_{tag}", path=path, ms=ms,
                             tflops=ops / ms / 1e9, bound_ms=ops / PEAK[path] * 1e3))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> None:
    run()


if __name__ == "__main__":
    main()
