"""The analytic counts of benchmark/counts/ against FlopCounterMode over the
program's plain step, and against the H100 numbers they replace."""

import pytest
import torch

from benchmark import counts
from benchmark.frozen.peaks import PEAK_BF16_FLOPS
from benchmark.harness import find_cell
from benchmark.run import Context, _merge
from benchmark.tests.tiny import TINY_WIDTHS, TRAIN

VIT_B = dict(embed_dim=768, depth=12, num_heads=12, mlp_dim=3072, patch_size=16,
             decoder_dim=512)


def _voc(**over):
    c = dict(batch_size=4, crop_size=448, pseudo_scales=[1.0, 0.5, 1.5], num_classes=21,
             energy_scale=0.5, energy_rff_features=1024, eval_scales=[1.0, 0.5, 1.5, 0.75, 1.25])
    return {**c, **over}


def test_full_width_step_flops_match_the_flop_counter_on_the_card():
    # FlopCounterMode over the program's plain step on an H100 read 7.1427
    # TFLOP for the VOC step and 14.3983 for COCO's batch 8 (cli/bench.py),
    # recorded to four decimals: the tolerance is that rounding alone, since
    # the tiny test below shows the two counts equal to the FLOP
    assert counts.train_step_flops(_voc(), VIT_B) / 1e12 == pytest.approx(7.1427, abs=5e-5)
    coco = _voc(batch_size=8, num_classes=81)
    assert counts.train_step_flops(coco, VIT_B) / 1e12 == pytest.approx(14.3983, abs=5e-5)


def test_tiny_step_flops_equal_the_flop_counter():
    """At vit_tiny_test on the CPU the counter runs the program's step; the
    analytic count must equal it (every product counted once, no other)."""
    from torch.utils.flop_counter import FlopCounterMode

    import cosa_tpu_torch.train.state as port_state
    import cosa_tpu_torch.train.step as port_step
    from cosa_tpu_torch.cli.bench import bmm_flops
    from benchmark.traffic.train import staged_batches

    cell = find_cell("voc.train_staged")
    for key, over in TRAIN.items():
        setattr(cell, key, _merge(getattr(cell, key), over))
    ctx = Context(cell, 3, torch.device("cpu"), "")
    cfg = ctx.port_config(mixed_precision=False)
    state = port_state.create_train_state(cfg, "cpu")
    state.step = cfg.warmup_iters + 1
    step = port_step.build_train_step(cfg)
    batch = staged_batches(cell.config["config"], cell.config["data"], 1, 3, "cpu")[0]
    with FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: bmm_flops}) as fc:
        step(state, batch)
    c = cell.config["config"]
    widths = dict(cell.config["widths"], **TINY_WIDTHS)
    assert counts.train_step_flops(c, widths) == fc.get_total_flops()


def test_attention_bounds_reproduce_the_kernel_table():
    # PERF.md's kernel table: K1's bound 0.0077 ms and K2's 0.0191 ms at
    # (B*H, N) = (48, 785), both bound by the operations
    fwd = counts.bound_seconds(*counts.attn_fwd_cost(48, 785, 64))
    bwd = counts.bound_seconds(*counts.attn_bwd_cost(48, 785, 64))
    assert fwd * 1e3 == pytest.approx(0.0077, abs=5e-5)
    assert bwd * 1e3 == pytest.approx(0.0191, abs=5e-5)
    ops, nbytes = counts.attn_fwd_cost(48, 785, 64)
    assert ops / PEAK_BF16_FLOPS > nbytes / 3.35e12


def test_attention_bound_of_a_step():
    calls = counts.train_step_calls(_voc())
    assert counts.attention_bound_s(VIT_B, calls, False) * 1e3 == pytest.approx(1.2395, rel=1e-3)
    assert counts.attention_bound_s(VIT_B, calls, True) * 1e3 == pytest.approx(0.2297, rel=1e-3)
