"""The kernels' launch counters behind one registry
(``cosa_tpu_torch/kernels/__init__.py``): each counter owner's keys, and
nothing else of it, in the merged snapshot, in a process that has imported
no wrapper too; a CPU call through each wrapper counts nothing; every CUDA
source is built by name."""

import json
import os
import subprocess
import sys

import pytest
import torch

from cosa_tpu_torch import kernels
from cosa_tpu_torch.kernels import build, cam2mask, flash, flash_variants, rff, tta_fuse, window_attn
from cosa_tpu_torch.models import quant


def _flash():
    qkv = torch.randn(1, 5, 3 * flash.HEAD_DIM, requires_grad=True)
    flash.flash_attention_qkv(qkv, 1, 0.125).sum().backward()


def _flash_variants():
    # the microbenchmark's kernel takes no plain path: a CPU tensor raises
    qkv = torch.randn(1, 5, 3 * flash.HEAD_DIM, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_variants.attn_fwd_variant(qkv, 1, 0.125, None, "nomax")


def _rff():
    rff.rff_phi(torch.rand(1, 6, rff.FEATURE_DIM), torch.randn(rff.FEATURE_DIM, 8),
                torch.randn(8), 0.5)


def _tta_fuse():
    tta_fuse.tta_fuse([torch.rand(2, 3, 3, 4)], [torch.rand(2, 3, 3, 5)], torch.rand(2, 3, 3, 4),
                      (8, 8))


def _window_attn():
    qkv = torch.randn(2, 4, 3, 1, 8, requires_grad=True)
    table = torch.randn(9, 1, requires_grad=True)
    window_attn.window_attention(qkv, table, 2).sum().backward()


def _cam2mask():
    box = torch.tensor([[0, 8, 0, 8]])
    cam2mask.cam2mask(box, torch.rand(1, 8, 8, 3), torch.tensor([[1.0, 0.0, 1.0]]), 0.7, 0.3)
    cam2mask.cam2mask(box, torch.rand(1, 8, 8, 3), torch.tensor([[1.0, 0.0, 1.0]]), 0.7, 0.3,
                      refine_fn=lambda imgs, probs: probs, images=torch.rand(1, 8, 8, 3))


def _quant():
    quant.int8_matmul(torch.randn(2, 3, 16), torch.nn.Linear(16, 8), torch.float32)


OWNERS = {
    "flash": (flash, {"flash_fwd", "flash_bwd"}, _flash),
    "flash_variants": (flash_variants, {"flash_fwd_bf16exp", "flash_fwd_nomax"},
                       _flash_variants),
    "rff": (rff, {"rff_phi"}, _rff),
    "tta_fuse": (tta_fuse, {"tta_fuse"}, _tta_fuse),
    "window_attn": (window_attn, {"window_attn_fwd", "window_attn_bwd"}, _window_attn),
    "cam2mask": (cam2mask, {"cam2mask", "cam2mask_probs"}, _cam2mask),
    "quant": (quant, {"int8_mm"}, _quant),
}


@pytest.mark.parametrize("owner", list(OWNERS))
def test_the_snapshot_holds_each_counter_and_a_cpu_call_counts_nothing(owner):
    mod, keys, cpu_call = OWNERS[owner]
    assert set(mod.LAUNCHES) == keys
    snap = kernels.launches()
    # every owner's keys and no others: no two counters share a key
    assert set(snap) == set().union(*(k for _, k, _ in OWNERS.values()))
    assert sum(len(k) for _, k, _ in OWNERS.values()) == len(snap)
    # the snapshot reads this module's own dict, and is a copy of it
    for k in keys:
        mod.LAUNCHES[k] += 1
    try:
        moved = kernels.launches()
        assert {k for k in moved if moved[k] != snap[k]} == keys
        assert all(snap[k] == moved[k] - 1 for k in keys)
    finally:
        kernels.reset_launches()
    assert set(kernels.launches().values()) == {0}
    cpu_call()
    assert kernels.launches() == dict.fromkeys(snap, 0)


def test_a_process_that_imported_no_wrapper_sees_every_counter():
    """A rank that imports only the training loop (no Swin model, no
    softmax variants) counts the same keys as the process it reports to."""
    code = ("import json, cosa_tpu_torch.parallel.launch\n"
            "from cosa_tpu_torch import kernels\n"
            "print(json.dumps(sorted(kernels.launches())))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert json.loads(out.splitlines()[-1]) == sorted(set().union(
        *(k for _, k, _ in OWNERS.values())))


def test_every_cuda_source_is_built_by_name():
    sources = {f for f in os.listdir(build.CSRC) if f.endswith(".cu")}
    assert sorted(build.SOURCES.values()) == sorted(sources)
    assert all(os.path.isfile(os.path.join(build.CSRC, f)) for f in build.SOURCES.values())
