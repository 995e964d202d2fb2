"""The work a cell asks of the chip, counted from the configuration's
shapes alone, whatever implements it.

* Model FLOPs: the matrix products and convolutions that the forward (and,
  where the step trains, the backward) requires, with no recomputation: the
  ViT's patch embedding, its qkv, proj and MLP products and its attention's
  two products per head, the LargeFOV convolutions, the CAM classifiers,
  and the RFF energy's three products. A backward costs twice its forward
  (the input's and the weight's gradient), except the patch embedding,
  whose input needs none, the aux CAM map, which enters no loss, and the
  attention, whose backward is four products.
* The least time of each attention kernel call: the larger of its
  operations at the peak rate and its bytes at the peak bandwidth, each
  input byte read once and each output byte written once. K1 (forward)
  does 4 BH N^2 d operations; K2 (backward) 10 BH N^2 d, the forward's
  QK^T recomputed with the four gradient products, as a flash backward
  must.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

from benchmark.frozen.peaks import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S


class Forward(NamedTuple):
    """One call of the network: ``batch`` images of ``h`` x ``w``, with its
    backward when ``grad``."""
    batch: int
    h: int
    w: int
    grad: bool


def tokens(widths: Dict, h: int, w: int) -> int:
    p = widths["patch_size"]
    return (h // p) * (w // p) + 1


def network_flops(widths: Dict, num_classes: int, f: Forward) -> float:
    """Model FLOPs of one call (forward, and backward with ``f.grad``)."""
    d, p, e = widths["embed_dim"], widths["patch_size"], widths["decoder_dim"]
    m, depth = widths["mlp_dim"], widths["depth"]
    b = f.batch
    grid = (f.h // p) * (f.w // p)
    n = grid + 1
    patch = 2 * b * grid * 3 * p * p * d
    dense = depth * 2 * b * n * d * (3 * d + d + 2 * m)
    attn = depth * 4 * b * n * n * d
    decoder = 2 * b * grid * (9 * d * e + 9 * e * e + e * num_classes)
    cam = 2 * b * grid * d * (num_classes - 1)  # each of the two CAM maps
    cls = 2 * b * d * (num_classes - 1)  # each of the two pooled logits
    fwd = patch + dense + attn + decoder + 2 * cam + 2 * cls
    if not f.grad:
        return float(fwd)
    # the aux CAM map enters no loss, so its product has no backward
    return float(fwd + patch + 2 * (dense + decoder + cam + 2 * cls) + 2 * attn)


def rff_energy_flops(c: Dict, batch: int, h: int, w: int) -> float:
    """The RFF energy's products: the 5 -> D embedding and Phi^T V, Phi (Phi^T V)."""
    s = c["energy_scale"]
    npx = int(h * s) * int(w * s)
    df = c["energy_rff_features"]
    return float(2 * batch * npx * df * (5 + 2 * c["num_classes"]))


def train_step_calls(c: Dict) -> List[Forward]:
    """The co-training step: the teacher's TTA (each scale's images and
    their flips), then the student's forward and backward."""
    b, s = c["batch_size"], c["crop_size"]
    calls = [Forward(2 * b, int(k * s), int(k * s), False) for k in c["pseudo_scales"]]
    return calls + [Forward(b, s, s, True)]


def eval_image_calls(c: Dict) -> List[Forward]:
    """One scored image: its eval scales, each with its flip."""
    s = c["crop_size"]
    return [Forward(2, int(k * s), int(k * s), False) for k in c["eval_scales"]]


def train_step_flops(c: Dict, widths: Dict) -> float:
    n = c["num_classes"]
    net = sum(network_flops(widths, n, f) for f in train_step_calls(c))
    return net + rff_energy_flops(c, c["batch_size"], c["crop_size"], c["crop_size"])


def eval_image_flops(c: Dict, widths: Dict) -> float:
    return sum(network_flops(widths, c["num_classes"], f) for f in eval_image_calls(c))


def attn_fwd_cost(bh: int, n: int, d: int):
    """(operations, bytes) of K1 over ``bh`` (batch x head) rows of ``n``
    tokens: reads the bf16 q, k, v; writes the bf16 output and the f32
    log-sum-exp."""
    return 4.0 * bh * n * n * d, float(bh * n * (3 * d * 2 + d * 2 + 4))


def attn_bwd_cost(bh: int, n: int, d: int):
    """(operations, bytes) of K2: reads q, k, v, the output's gradient and
    the log-sum-exp; writes the gradients of q, k and v."""
    return 10.0 * bh * n * n * d, float(bh * n * (3 * d * 2 + d * 2 + 4 + 3 * d * 2))


def bound_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def attention_bound_s(widths: Dict, calls: List[Forward], backward: bool) -> float:
    """The least seconds of the attention kernels that ``calls`` launch:
    every layer's forward (``backward`` False) or the backward of the calls
    that train."""
    heads, depth = widths["num_heads"], widths["depth"]
    d = widths["embed_dim"] // heads
    total = 0.0
    for f in calls:
        if backward and not f.grad:
            continue
        n = tokens(widths, f.h, f.w)
        cost = attn_bwd_cost if backward else attn_fwd_cost
        total += depth * bound_seconds(*cost(f.batch * heads, n, d))
    return total
