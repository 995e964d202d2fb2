"""The work of the Swin CoSA network (reference/swin.py) in a cell, counted
from the configuration's shapes alone, whatever implements it.

* Model FLOPs, with the conventions of the ViT's count
  (benchmark/counts/__init__.py): the matrix products and convolutions the
  forward requires, and a backward twice its forward, except the patch
  embedding (whose input needs no gradient), the aux CAM map (which enters
  no loss) and the window attention (whose backward is four products to
  the forward's two). Per block: qkv, proj and the attention's two
  products over the grid padded to whole windows, the MLP over the grid;
  patch merging after each stage but the last; LargeFOV and the CAM on
  the last stage's grid, the aux CAM on the aux block's.
* The window-attention calls of a step (``WINDOW_ATTN`` of
  models/zoo/swin.py counts the program's): one a block and forward, with
  its batch, windows an image, heads, tokens a window, head width, and
  whether it carries a shift or pad mask. The TTA's images and their flips
  go through one forward, so a call's batch is twice the images there.
* Each call's least time: the larger of its operations, 4 x batch x
  windows x heads x tokens^2 x head width, at the bf16 peak, and its bytes at
  the peak bandwidth: q, k, v and the output in the compute dtype, the f32
  bias table, and the f32 mask where there is one, each read or written
  once.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

from benchmark.counts import Forward, bound_seconds, rff_energy_flops, train_step_calls


class WindowCall(NamedTuple):
    """One call of the window attention: ``batch`` images of ``windows``
    windows each, ``heads`` heads of ``head_dim``, ``tokens`` a window."""
    phase: str  # "teacher" (the TTA) or "student"
    scale: float
    stage: int
    block: int
    batch: int
    windows: int
    heads: int
    tokens: int
    head_dim: int
    masked: bool


def _up(n: int, k: int) -> int:
    return -(-n // k) * k


def stage_grids(widths: Dict, h: int, w: int) -> List[Tuple[int, int]]:
    """Each stage's (h, w) grid for an h x w input: the patch embedding
    pads to whole patches, each merge to an even grid."""
    gh, gw = -(-h // widths["patch_size"]), -(-w // widths["patch_size"])
    grids = []
    for _ in widths["depths"]:
        grids.append((gh, gw))
        gh, gw = -(-gh // 2), -(-gw // 2)
    return grids


def _blocks(widths: Dict, h: int, w: int):
    """(stage, block, dim, heads, grid, padded grid, shifted) of each block."""
    win = widths["window"]
    for i, ((gh, gw), depth) in enumerate(zip(stage_grids(widths, h, w), widths["depths"])):
        hp, wp = _up(gh, win), _up(gw, win)
        for j in range(depth):
            yield (i, j, widths["embed_dim"] * 2 ** i, widths["num_heads"][i], (gh, gw),
                   (hp, wp), j % 2 == 1 and min(hp, wp) > win)


def network_flops(widths: Dict, num_classes: int, aux_layer: int, f: Forward) -> float:
    """Model FLOPs of one call (forward, and backward with ``f.grad``)."""
    b, p, win = f.batch, widths["patch_size"], widths["window"]
    e, m, k = widths["decoder_dim"], widths["mlp_ratio"], num_classes - 1
    grids = stage_grids(widths, f.h, f.w)
    patch = 2 * b * grids[0][0] * grids[0][1] * 3 * p * p * widths["embed_dim"]
    dense = attn = 0
    dims, sizes = [], []
    for _, _, d, _, (gh, gw), (hp, wp), _ in _blocks(widths, f.h, f.w):
        dense += 2 * b * hp * wp * d * 4 * d + 2 * b * gh * gw * d * 2 * m * d
        attn += 4 * b * hp * wp * win * win * d
        dims.append(d)
        sizes.append(gh * gw)
    for i, (gh, gw) in enumerate(grids[:-1]):
        d = widths["embed_dim"] * 2 ** i
        dense += 2 * b * -(-gh // 2) * -(-gw // 2) * 4 * d * 2 * d
    d, g = dims[-1], sizes[-1]
    da, ga = dims[aux_layer], sizes[aux_layer]
    decoder = 2 * b * g * (9 * d * e + 9 * e * e + e * num_classes)
    cam, cam_aux = 2 * b * g * d * k, 2 * b * ga * da * k
    cls = 2 * b * (d + da) * k  # the two pooled logits
    fwd = patch + dense + attn + decoder + cam + cam_aux + cls
    if not f.grad:
        return float(fwd)
    # the aux CAM map enters no loss, so its product has no backward
    return float(fwd + patch + 2 * (dense + decoder + cam + cls) + 2 * attn)


def train_step_flops(c: Dict, widths: Dict) -> float:
    """The co-training step: the teacher's TTA, the student's forward and
    backward, the RFF energy's products."""
    n = c["num_classes"]
    net = sum(network_flops(widths, n, c["aux_layer"], f) for f in train_step_calls(c))
    return net + rff_energy_flops(c, c["batch_size"], c["crop_size"], c["crop_size"])


def window_calls(widths: Dict, f: Forward, phase: str, scale: float) -> List[WindowCall]:
    win = widths["window"]
    out = []
    for i, j, d, heads, grid, (hp, wp), shifted in _blocks(widths, f.h, f.w):
        out.append(WindowCall(phase, scale, i, j, f.batch, (hp // win) * (wp // win), heads,
                              win * win, d // heads, shifted or (hp, wp) != grid))
    return out


def train_step_window_calls(c: Dict, widths: Dict) -> List[WindowCall]:
    """Every window-attention call of a step's forwards, in the order the
    step makes them: the TTA's scales, then the student."""
    calls = train_step_calls(c)
    scales = list(c["pseudo_scales"]) + [1.0]
    return [wc for f, s in zip(calls, scales)
            for wc in window_calls(widths, f, "student" if f.grad else "teacher", s)]


def window_call_cost(call: WindowCall, value_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one call (module docstring)."""
    bw, n = call.batch * call.windows, call.tokens
    ops = 4.0 * bw * call.heads * n * n * call.head_dim
    table = (2 * math.isqrt(n) - 1) ** 2 * call.heads * 4
    nbytes = 4 * bw * call.heads * n * call.head_dim * value_bytes + table
    if call.masked:
        nbytes += call.windows * n * n * 4
    return ops, float(nbytes)


def window_attn_bound_s(c: Dict, widths: Dict) -> float:
    """The least seconds of a step's window-attention forwards."""
    value_bytes = 2 if c["mixed_precision"] else 4
    return sum(bound_seconds(*window_call_cost(wc, value_bytes))
               for wc in train_step_window_calls(c, widths))
