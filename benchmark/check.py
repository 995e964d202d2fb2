"""The numbers that decide ``correct``: the program's outputs held against
the plain reference's, each number against its cell's limit
(benchmark/workloads/<cell>.json, which gives the readings each limit was
set from).

Training (the first steps of the program's own training state):

* ``logit_err``: the first step's image-level logits of the student's two
  heads (every encoder layer, the aux tap and the classifiers, before any
  pseudo label or update), |l_p - l_r| / |l_r| over the batch; a batch
  whose rows differ in number reads 1;
* ``tta_err``: the same measure, the largest over what the first step's
  teacher TTA produced: the fused CAM, the aux CAM and the summed seg
  logits (each also a reading of its own, ``tta_err.<name>``);
* ``soft_err``: the same measure of the soft CAM targets made from the
  TTA's seg logits (``seg_refine_by_label``, a softmax at temperature
  0.01, so it sharpens the seg logits' round-off);
* ``seg_err``: the same measure of the student's first-step seg logits
  (the LargeFOV decoder's output);
* ``mask_flip``: the share of pixels whose first-step pseudo label (either
  head's ``cam2mask``) differs from the reference's, the larger of the
  two heads;
* ``loss_gap``: over the loss terms the first step logs (overall, cls, aux
  cls, seg, CAM, energy), the largest relative gap |program - reference| /
  |reference|. The later steps' gaps are readings only: Adam's first update
  moves every entry by about its learning rate in the direction of its
  gradient's sign, so round-off in the smallest gradients becomes whole
  steps of difference, and the later losses drift apart by that noise;
* ``grad_gap``: over the student's leaves, the largest gap between the norm
  of the first step's gradient as the optimizer holds it and the
  reference's, |n_p - n_r| / max(n_r, median leaf's n_r). Leaves whose
  reference gradient norm is below a thousandth of the median leaf's are
  left out;
* ``grad_err``: the median kept leaf's |g_p - g_r| / |g_r|, the first
  gradient's relative error (steady from seed to seed, where the norm gaps
  hide an error that leaves the norm alone);
* ``update_gap``: the same measure as ``grad_gap`` of each kept leaf's change over the
  steps; ``ema_gap``: of each of the EMA teacher's leaves. The changes
  leave out the entries whose reference gradient is below a thousandth of
  the median leaf's root mean square entry: a key's bias under softmax has
  a gradient of round-off alone, and Adam moves it by the sign of that
  round-off. The key's bias shares the packed qkv bias with the query's and
  the value's, so the rule is on entries, and on the reference's gradient,
  never on names.

* ``update_sign``: over the kept leaves' entries whose first reference
  gradient is at least its leaf's root mean square, the share whose change
  over the steps has another sign than the reference's. Adam moves such an
  entry by about its learning rate against the sign of its gradient, so the
  norms above cannot see a step taken the wrong way, or a gradient taken
  over other rows; this number can.

A leaf that one side leaves unmoved, or moves double, reads about 1.

Validation (sampled batches of the measured window's first pass):

* ``hist_gap``: the share of counted pixels that the program's CAM, aux
  CAM, Seg_ps and Seg_vd confusion matrices put in another cell than the
  reference's, the largest over the sampled batches;
* ``seg_gap``: over the sampled images' pixels, the widest gap by which the
  reference's validated seg logit of the program's Seg_vd label lies below
  the reference's best, over the mean magnitude of that best.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

LEAF_FLOOR = 1e-3  # share of the median leaf's reference gradient below which it is left out
TTA = ("cam", "cam_aux", "seg")  # the first step's teacher TTA outputs
MASKS = ("mask", "mask_aux")  # the first step's pseudo masks, main and aux head


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, as the reference is defined."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _norm(t) -> float:
    return 0.0 if t is None else float(torch.linalg.vector_norm(t.double()))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The worst leaf's |n_p - n_r| / max(n_r, median n_r) over ``ref``'s leaves."""
    vals = sorted(ref.values())
    med = vals[len(vals) // 2]
    return max(abs(prog.get(k, 0.0) - r) / max(r, med) for k, r in ref.items())


def rel_err(p, r) -> float:
    """|p - r| / |r|; 1 where ``p`` is missing or of another shape."""
    if p is None or p.shape != r.shape:
        return 1.0
    return _norm(p.double() - r.double()) / max(_norm(r), 1e-30)


def flip_share(p, r) -> float:
    """The share of the entries of two label maps that differ; 1 where ``p``
    is missing or of another shape."""
    if p is None or p.shape != r.shape:
        return 1.0
    return float((p.to(torch.int64) != r.to(torch.int64)).double().mean())


def sign_share(prog: Dict, ref: Dict, init: Dict, grads: Dict, kept) -> float:
    """``update_sign`` (module docstring)."""
    other = total = 0
    for k in kept:
        g = grads[k].abs()
        big = g >= float(torch.linalg.vector_norm(g.double())) / g.numel() ** 0.5
        dp = torch.sign(prog[k] - init[k])[big]
        dr = torch.sign(ref[k] - init[k])[big]
        other += int((dp != dr).sum())
        total += int(big.sum())
    return other / max(total, 1)


def train_numbers(prog: Dict, ref: Dict, init: Dict) -> Dict[str, float]:
    def gap(p, r, k):
        return abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)

    steps = list(zip(prog["losses"], ref["losses"]))
    readings = {f"loss_gap.step{i + 1}": max(gap(p, r, k) for k in r)
                for i, (p, r) in enumerate(steps)}
    readings.update({f"loss_gap.{k}": max(gap(p, r, k) for p, r in steps)
                     for k in ref["losses"][0]})
    g_ref = {k: _norm(v) for k, v in ref["grads"].items()}
    med = sorted(g_ref.values())[len(g_ref) // 2]
    kept = [k for k, v in g_ref.items() if v >= LEAF_FLOOR * med]
    g_prog = {k: _norm(prog["grads"].get(k)) for k in kept}
    errs = sorted(_norm(prog["grads"][k] - ref["grads"][k]) / g_ref[k]
                  if k in prog["grads"] else 1.0 for k in kept)
    rms = sorted(g_ref[k] / ref["grads"][k].numel() ** 0.5 for k in g_ref)[len(g_ref) // 2]
    moved = {k: ref["grads"][k].abs() >= LEAF_FLOOR * rms for k in kept}

    def change(rec, side, names):
        out = {}
        for k in names:
            d = rec[side][k] - init[side][k]
            out[k] = _norm(d[moved[k]] if k in moved else d)
        return out

    complete = len(prog["losses"]) == len(ref["losses"])
    fp, fr = prog["first"], ref["first"]
    readings.update({f"tta_err.{k}": rel_err(fp.get(k), fr[k]) for k in TTA})
    readings.update({f"mask_flip.{k}": flip_share(fp.get(k), fr[k]) for k in MASKS})
    return dict(
        logit_err=rel_err(prog["logits"], ref["logits"]),
        tta_err=max(readings[f"tta_err.{k}"] for k in TTA),
        soft_err=rel_err(fp.get("soft"), fr["soft"]),
        seg_err=rel_err(fp.get("seg_logits"), fr["seg_logits"]),
        mask_flip=max(readings[f"mask_flip.{k}"] for k in MASKS),
        update_sign=sign_share(prog["student"], ref["student"], init["student"], ref["grads"],
                               kept),
        loss_gap=readings["loss_gap.step1"] if complete else float("inf"),
        grad_gap=leaf_gap(g_prog, {k: g_ref[k] for k in kept}),
        grad_err=errs[len(errs) // 2],
        update_gap=leaf_gap(change(prog, "student", kept), change(ref, "student", kept)),
        ema_gap=leaf_gap(change(prog, "teacher", init["teacher"]),
                         change(ref, "teacher", init["teacher"])),
        **readings,
    )


def eval_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: per sampled batch, ``hists`` (4, n, n) and, for
    the program, ``labels`` (B, P, P) its Seg_vd labels; for the reference,
    ``seg_vd`` (B, P, P, n) its validated seg logits and ``valid`` (B, P, P)
    the pixels inside the images."""
    hist_gap = seg_gap = 0.0
    for p, r in zip(prog, ref):
        if p["labels"].shape != r["valid"].shape:
            return dict(hist_gap=float("inf"), seg_gap=float("inf"))
        hp, hr = p["hists"].double(), r["hists"].double()
        hist_gap = max(hist_gap, float((hp - hr).abs().sum() / 2 / hr.sum()))
        logits = r["seg_vd"].double()
        best = logits.amax(dim=-1)
        chosen = logits.gather(-1, p["labels"].to(logits.device, torch.int64)[..., None])[..., 0]
        valid = r["valid"]
        scale = float(best[valid].abs().mean())
        seg_gap = max(seg_gap, float((best - chosen)[valid].max()) / scale)
    if len(prog) != len(ref):
        hist_gap = float("inf")
    return dict(hist_gap=hist_gap, seg_gap=seg_gap)
