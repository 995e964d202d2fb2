"""FLOP count of a call by ``torch.utils.flop_counter.FlopCounterMode``.

The benchmark's tests hold ``benchmark/counts/``'s analytic FLOPs to this
count (``benchmark/tests/test_benchmark_counts.py``,
``tests/test_torch_benchmark_swin.py``), and import :func:`bmm_flops` from
this module path.
"""

from __future__ import annotations

from typing import Callable


def bmm_flops(a_shape, b_shape, *_, out_shape=None, **kwargs) -> int:
    """2 b m n k for ``bmm``, its ``out_dtype`` overload included: that one
    (the RFF filter's bf16 product into f32 on the card) passes the dtype
    third, where the counter's own formula takes the output's shape."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[2]


def count_flops(fn: Callable) -> int:
    """The FLOPs of one call of ``fn`` (matrix products and convolutions,
    forward and backward), by FlopCounterMode."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: bmm_flops}) as counter:
        fn()
    return int(counter.get_total_flops())
