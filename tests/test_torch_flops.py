"""The FLOP count that the benchmark's analytic counts are held to
(``cosa_tpu_torch/cli/bench.py``): FlopCounterMode sees the plain attention
of a whole step exactly, and the custom ``bmm`` formula takes the
``out_dtype`` overload that the counter's own formula breaks on."""

import numpy as np
import torch

from cosa_tpu_torch.cli import bench
from cosa_tpu_torch.config import voc_config
from cosa_tpu_torch.models import vit
from cosa_tpu_torch.train.state import create_train_state
from cosa_tpu_torch.train.step import build_train_step


def _batch(cfg, n: int):
    """One batch of random uint8 images and labels."""
    rng = np.random.default_rng(0)
    s = cfg.crop_size
    host = dict(
        wimg=rng.integers(0, 255, (n, s, s, 3)).astype(np.uint8),
        simg=rng.integers(0, 255, (n, s, s, 3)).astype(np.uint8),
        cls_label=(rng.random((n, cfg.num_classes - 1)) > 0.8).astype(np.float32),
        img_box=np.tile(np.array([[0, s, 0, s]], np.int32), (n, 1)),
    )
    return {k: torch.from_numpy(v) for k, v in host.items()}


def test_flop_counter_sees_the_plain_attention(monkeypatch):
    """A whole step's count with the plain attention minus its count with a
    stub (which returns v, no product) is 4 B H N^2 d per forward call and
    8 B H N^2 d more per call the backward goes through, exactly. On the
    CPU every attention takes its plain version."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = voc_config(batch_size=2, energy_convention=1.0, backbone="vit_tiny_test",
                     crop_size=64, mixed_precision=False)
    state = create_train_state(cfg, "cpu", 2)
    step = build_train_step(cfg)
    batch = _batch(cfg, 2)
    calls = []
    real = vit.attention

    def recorded(qkv, num_heads, scale, use_kernel, n_valid=None):
        b, n, c3 = qkv.shape
        calls.append((b * num_heads * n * n * (c3 // 3 // num_heads), qkv.requires_grad))
        return real(qkv, num_heads, scale, use_kernel, n_valid)

    def stub(qkv, num_heads, scale, use_kernel, n_valid=None):
        return qkv[..., 2 * qkv.shape[-1] // 3:]

    try:
        monkeypatch.setattr(vit, "attention", recorded)
        with_attn = bench.count_flops(lambda: step(state, batch))
        monkeypatch.setattr(vit, "attention", stub)
        without = bench.count_flops(lambda: step(state, batch))
    finally:
        torch.set_num_threads(threads)
    # 3 blocks x (3 teacher scales + 1 student); the student's 3 take the backward
    assert len(calls) == 12 and sum(g for _, g in calls) == 3
    assert with_attn - without == sum(4 * w + (8 * w if g else 0) for w, g in calls)


def test_bmm_flops_take_the_out_dtype_overload():
    a, b = torch.randn(3, 5, 7), torch.randn(3, 7, 11)
    assert bench.bmm_flops(a.shape, b.shape, torch.float32, out_shape=(3, 5, 11)) == 2310
    assert bench.count_flops(lambda: torch.bmm(a, b)) == 2 * 3 * 5 * 7 * 11
