"""The plain Swin CoSA network and its co-training step: the MMSWIN wrapper
of CoSA's code (youshyee/CoSA models/mmsegmodel/__init__.py:77-350, over
mmseg's Swin Transformer; Liu et al., arXiv:2103.14030) with the LargeFOV
decoder and the two CAM heads, as functions of a dict of weights.

The weights are keyed by the names of the published MMSWIN state dict: the
mmseg Swin backbone's (``backbone.patch_embed.projection.weight``,
``backbone.stages.{i}.blocks.{j}.attn.w_msa.qkv.weight``,
``...attn.w_msa.relative_position_bias_table``, ``...ffn.layers.0.0.weight``,
``backbone.stages.{i}.downsample.reduction.weight``, ``backbone.norm3.weight``)
and the heads' (``decoder.conv6.weight``, ``classifier.weight``, ...).
Everything runs in float32 with plain softmax(QK^T + B + M)V in each window
and the exact GELU; the caller turns TF32 off. ``precision="fp8"`` is the
control of reference/model.py, here also on the attention's two products.

The network, per block: x + DropPath(W-MSA(LN(x))), then x + DropPath(MLP(LN(x))),
the attention in 7 x 7 windows (``window``), every other block's windows
shifted by half a window with a cyclic roll and an additive mask of -100
between the rolled regions (mmseg's value), a learned bias per head read
from a (2w-1)^2 table at the official relative-position index. Stages are
joined by patch merging: each 2 x 2 block unfolded channel-major (mmcv's
``nn.Unfold`` order, c * 4 + row * 2 + col), LayerNorm, a bias-free 4C -> 2C
product. The last stage's output is normed (``norm3``) and feeds LargeFOV and
the CAM; the aux CAM reads the block ``aux_layer`` counts back from the end
of the flat list of blocks, un-normed, on its own (finer) grid.

Departures from MMSWIN, each the program's rule and the JAX package's:

* a block whose padded grid is a single window does not shift (the
  official Swin's rule for a resolution no larger than the window; mmseg
  shifts and masks the four regions). At the cell's sizes (a 448 crop at
  scales 0.5, 1 and 1.5) this is stage 3 at scale 0.5;
* padded positions are masked as keys with the same -100 (mmseg lets the
  zero pad tokens be keys). No padding arises at the cell's sizes: every
  stage's grid is a multiple of 7 there.

Stochastic depth, live only in the student's forward of the step: the
rates rise linearly from 0 at the first block to ``drop_path_rate`` at the
last; for each residual branch whose rate p lies strictly between 0 and 1,
in block order (attention, then MLP), one ``rand((B, 1, 1, 1))`` from the
step's generator (:func:`drop_path_generator`) keeps the sample where it is
below 1 - p and scales the kept branch by 1 / (1 - p).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.cosa import BETAS, EPS, FAULTS, TrainStep, check_supported
from benchmark.reference.model import round_operand

MASK = -100.0  # mmseg's additive mask between shifted regions


def stage_dims(widths: Dict) -> List[int]:
    return [widths["embed_dim"] * 2 ** i for i in range(len(widths["depths"]))]


def relative_position_index(w: int) -> torch.Tensor:
    """(w^2, w^2) index into the (2w-1)^2 table (the official Swin's
    formula)."""
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    flat = torch.stack([ys.flatten(), xs.flatten()])
    rel = (flat[:, :, None] - flat[:, None, :]) + (w - 1)
    return rel[0] * (2 * w - 1) + rel[1]


def window_mask(hp: int, wp: int, w: int, shift: int, h: int, wd: int) -> Optional[torch.Tensor]:
    """(windows, w^2, w^2) additive mask of a padded (hp, wp) grid whose
    first (h, wd) positions hold the image, rolled by ``shift``; None where
    nothing is masked."""
    if shift == 0 and (hp, wp) == (h, wd):
        return None
    region = torch.zeros((hp, wp), dtype=torch.int64)
    if shift:
        cuts = (slice(0, hp - w), slice(hp - w, hp - shift), slice(hp - shift, hp))
        cuts_w = (slice(0, wp - w), slice(wp - w, wp - shift), slice(wp - shift, wp))
        for i, a in enumerate(cuts):
            for j, b in enumerate(cuts_w):
                region[a, b] = 3 * i + j
    pad = torch.ones((hp, wp), dtype=torch.bool)
    pad[:h, :wd] = False
    pad = torch.roll(pad, (-shift, -shift), dims=(0, 1))  # the pad band moves with the data
    region[pad] = -1
    win = region.reshape(hp // w, w, wp // w, w).permute(0, 2, 1, 3).reshape(-1, w * w)
    keep = (win[:, :, None] == win[:, None, :]) & (win[:, None, :] >= 0)
    return torch.where(keep, 0.0, MASK)


def drop_path_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of the student's stochastic depth at ``step``: seeded
    with the first 64-bit word of ``SeedSequence([seed, step])``."""
    key = int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(key)


class SwinNetwork:
    """The MMSWIN network of one configuration's widths (module docstring).
    ``drop`` is the stochastic depth's generator while the student's
    forward draws, else None."""

    def __init__(self, widths: Dict, aux_layer: int, precision: str = "f32"):
        self.widths = widths
        self.aux_layer = aux_layer
        self.precision = precision
        self.drop: Optional[torch.Generator] = None
        total = sum(widths["depths"])
        self.rates = [widths["drop_path_rate"] * i / max(total - 1, 1) for i in range(total)]

    def _r(self, x):
        return round_operand(x, self.precision)

    def _linear(self, x, w, name):
        y = self._r(x) @ self._r(w[name + ".weight"]).t()
        bias = w.get(name + ".bias")
        return y if bias is None else y + bias

    def _conv(self, x, weight, stride=1, dilation=1):
        pad = dilation * (weight.shape[-1] // 2) if stride == 1 else 0
        return F.conv2d(self._r(x), self._r(weight), stride=stride, padding=pad,
                        dilation=dilation)

    def _ln(self, x, w, name):
        return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"], w[name + ".bias"],
                            self.widths["ln_eps"])

    def _drop(self, y, rate):
        if self.drop is None or not 0.0 < rate < 1.0:
            return y
        keep = 1.0 - rate
        m = torch.rand((y.shape[0], 1, 1, 1), generator=self.drop, device=y.device) < keep
        return torch.where(m, y / keep, torch.zeros_like(y))

    def _attention(self, xw, w, name, heads, mask):
        """xw (B * windows, n, C) -> (B * windows, n, C)."""
        bn, n, c = xw.shape
        hd = c // heads
        win = self.widths["window"]
        qkv = self._linear(xw, w, name + ".qkv").reshape(bn, n, 3, heads, hd)
        q, k, v = qkv.unbind(2)
        s = torch.einsum("bqhd,bkhd->bhqk", self._r(q * hd ** -0.5), self._r(k))
        idx = relative_position_index(win).to(xw.device)
        s = s + w[name + ".relative_position_bias_table"][idx].permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            s = (s.reshape(bn // nw, nw, heads, n, n) + mask[None, :, None]).reshape(bn, heads, n, n)
        o = torch.einsum("bhqk,bkhd->bqhd", self._r(torch.softmax(s, dim=-1)), self._r(v))
        return self._linear(o.reshape(bn, n, c), w, name + ".proj")

    def _block(self, x, w, name, heads, shifted, rate):
        b, h, wd, c = x.shape
        win = self.widths["window"]
        hp, wp = -(-h // win) * win, -(-wd // win) * win
        shift = win // 2 if shifted and min(hp, wp) > win else 0
        y = F.pad(self._ln(x, w, name + ".norm1"), (0, 0, 0, wp - wd, 0, hp - h))
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = y.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
        mask = window_mask(hp, wp, win, shift, h, wd)
        y = self._attention(y.reshape(-1, win * win, c), w, name + ".attn.w_msa", heads,
                            None if mask is None else mask.to(x.device))
        y = y.reshape(b, hp // win, wp // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
        y = torch.roll(y.reshape(b, hp, wp, c), (shift, shift), dims=(1, 2))[:, :h, :wd]
        x = x + self._drop(y, rate)
        y = F.gelu(self._linear(self._ln(x, w, name + ".norm2"), w, name + ".ffn.layers.0.0"))
        return x + self._drop(self._linear(y, w, name + ".ffn.layers.1"), rate)

    def _merge(self, x, w, name):
        b, h, wd, c = x.shape
        x = F.pad(x, (0, 0, 0, wd % 2, 0, h % 2)).permute(0, 3, 1, 2)
        x = F.unfold(x, kernel_size=2, stride=2)  # (B, 4C, L), channel-major
        x = x.transpose(1, 2).reshape(b, (h + h % 2) // 2, (wd + wd % 2) // 2, 4 * c)
        return self._linear(self._ln(x, w, name + ".norm"), w, name + ".reduction")

    def backbone(self, x, w):
        """x (B, H, W, 3) normalized -> (the normed last stage, every block's map)."""
        p = self.widths["patch_size"]
        h, wd = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, -wd % p, 0, -h % p)).permute(0, 3, 1, 2)
        x = self._conv(x, w["backbone.patch_embed.projection.weight"], stride=p)
        x = x + w["backbone.patch_embed.projection.bias"][:, None, None]
        x = self._ln(x.permute(0, 2, 3, 1), w, "backbone.patch_embed.norm")
        blocks, k = [], 0
        depths = self.widths["depths"]
        for i, depth in enumerate(depths):
            for j in range(depth):
                x = self._block(x, w, f"backbone.stages.{i}.blocks.{j}",
                                self.widths["num_heads"][i], j % 2 == 1, self.rates[k])
                blocks.append(x)
                k += 1
            if i < len(depths) - 1:
                x = self._merge(x, w, f"backbone.stages.{i}.downsample")
        return self._ln(x, w, f"backbone.norm{len(depths) - 1}"), blocks

    def __call__(self, x, w) -> Dict[str, torch.Tensor]:
        """x (B, H, W, 3) normalized -> cls, cls_aux (B, C-1); seg (B, h, w, C);
        cam (B, h, w, C-1) on the last stage's grid, cam_aux on the aux
        block's."""
        fmap, blocks = self.backbone(x, w)
        fmap_aux = blocks[self.aux_layer]
        dil = self.widths["decoder_dilation"]
        y = fmap.permute(0, 3, 1, 2)
        y = F.relu(self._conv(y, w["decoder.conv6.weight"], dilation=dil))
        y = F.relu(self._conv(y, w["decoder.conv7.weight"], dilation=dil))
        seg = self._conv(y, w["decoder.conv8.weight"]).permute(0, 2, 3, 1)
        wc = w["classifier.weight"][:, :, 0, 0].t()
        wa = w["aux_classifier.weight"][:, :, 0, 0].t()
        return dict(cls=self._r(fmap.amax(dim=(1, 2))) @ self._r(wc),
                    cls_aux=self._r(fmap_aux.amax(dim=(1, 2))) @ self._r(wa),
                    seg=seg, cam=self._r(fmap) @ self._r(wc),
                    cam_aux=self._r(fmap_aux) @ self._r(wa))


def weight_shapes(widths: Dict, num_classes: int, aux_layer: int) -> Dict[str, tuple]:
    """The published MMSWIN state dict's names and shapes for ``widths``
    and the aux CAM's block (the backbone's ``relative_position_index``
    buffers left out: a constant of the window)."""
    c, p, e, win = widths["embed_dim"], widths["patch_size"], widths["decoder_dim"], \
        widths["window"]
    m = widths["mlp_ratio"]
    dims = stage_dims(widths)
    shapes = {"backbone.patch_embed.projection.weight": (c, 3, p, p),
              "backbone.patch_embed.projection.bias": (c,),
              "backbone.patch_embed.norm.weight": (c,), "backbone.patch_embed.norm.bias": (c,)}
    for i, (depth, d) in enumerate(zip(widths["depths"], dims)):
        heads = widths["num_heads"][i]
        for j in range(depth):
            n = f"backbone.stages.{i}.blocks.{j}"
            for name, shape in (
                    ("norm1.weight", (d,)), ("norm1.bias", (d,)),
                    ("attn.w_msa.relative_position_bias_table", ((2 * win - 1) ** 2, heads)),
                    ("attn.w_msa.qkv.weight", (3 * d, d)), ("attn.w_msa.qkv.bias", (3 * d,)),
                    ("attn.w_msa.proj.weight", (d, d)), ("attn.w_msa.proj.bias", (d,)),
                    ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                    ("ffn.layers.0.0.weight", (m * d, d)), ("ffn.layers.0.0.bias", (m * d,)),
                    ("ffn.layers.1.weight", (d, m * d)), ("ffn.layers.1.bias", (d,))):
                shapes[f"{n}.{name}"] = shape
        if i < len(dims) - 1:
            n = f"backbone.stages.{i}.downsample"
            shapes.update({f"{n}.norm.weight": (4 * d,), f"{n}.norm.bias": (4 * d,),
                           f"{n}.reduction.weight": (2 * d, 4 * d)})
    last = len(dims) - 1
    blocks = [d for d, depth in zip(dims, widths["depths"]) for _ in range(depth)]
    shapes.update({f"backbone.norm{last}.weight": (dims[-1],),
                   f"backbone.norm{last}.bias": (dims[-1],),
                   "decoder.conv6.weight": (e, dims[-1], 3, 3), "decoder.conv7.weight": (e, e, 3, 3),
                   "decoder.conv8.weight": (num_classes, e, 1, 1),
                   "classifier.weight": (num_classes - 1, dims[-1], 1, 1),
                   "aux_classifier.weight": (num_classes - 1, blocks[aux_layer], 1, 1)})
    return shapes


def param_group(name: str) -> str:
    """MMSWIN's optimizer groups (mmsegmodel/__init__.py:88,131-148): the
    backbone's norms and relative-position bias tables in ``norm``, the
    rest of the backbone in ``backbone``, the CAM classifiers in ``head``,
    LargeFOV in ``decoder``."""
    if name.startswith("backbone"):
        return "norm" if ("norm" in name or "relative_position_bias_table" in name) \
            else "backbone"
    if "classifier" in name:
        return "head"
    if name.startswith("decoder"):
        return "decoder"
    return "backbone"


class SwinTrainStep(TrainStep):
    """reference/cosa.py's step over the Swin network: the same TTA,
    pseudo labels, losses, AdamW, EMA and planted faults, with MMSWIN's
    parameter groups and the student's stochastic depth drawn from
    ``(seed, step)``."""

    def __init__(self, c: Dict, widths: Dict, student: Dict[str, torch.Tensor],
                 teacher: Dict[str, torch.Tensor], step: int, precision: str = "f32",
                 fault: str = "", seed: int = 0):
        check_supported(c)
        if fault not in FAULTS:
            raise ValueError(f"fault {fault!r}: one of {FAULTS}")
        self.c, self.fault, self.seed = c, fault, seed
        self.first: Optional[Dict[str, torch.Tensor]] = None
        self.net = SwinNetwork(widths, c["aux_layer"], precision)
        self.student = {k: v.detach().clone().to(torch.float32).requires_grad_(True)
                        for k, v in student.items()}
        self.teacher = {k: v.detach().clone().to(torch.float32) for k, v in teacher.items()}
        self.step = step
        self.mult = dict(backbone=1.0, norm=1.0, head=c["lrscale"], decoder=c["lrscale"])
        groups = {g: [] for g in self.mult}
        for k, p in self.student.items():
            groups[param_group(k)].append(p)
        self.groups = [g for g in self.mult if groups[g]]
        wd = dict(backbone=c["wt_dec"], norm=c["wt_dec"] * c["wt_dec_mult"],
                  head=c["wt_dec"], decoder=c["wt_dec"])
        self.opt = torch.optim.AdamW(
            [dict(params=groups[g], lr=0.0, weight_decay=wd[g]) for g in self.groups],
            betas=BETAS, eps=EPS, foreach=False, fused=False)

    def losses(self, simg, cls_label, img_box, targets) -> Dict[str, torch.Tensor]:
        """The step's losses with the student's stochastic depth live."""
        self.net.drop = drop_path_generator(self.seed, self.step, simg.device)
        try:
            return super().losses(simg, cls_label, img_box, targets)
        finally:
            self.net.drop = None
