"""The plain CoSA network: ViT encoder, LargeFOV decoder and the two CAM
heads, as functions of a dict of weights.

The weights are keyed by the names of the published CoSA state dict
(``encoder.blocks.{i}.attn.qkv.weight``, ``decoder.conv6.weight``,
``classifier.weight``, ...), so the benchmark hands the same tensors to the
program and to this reference. Everything runs in float32 with plain
softmax(QK^T)V attention and the exact GELU; the caller turns TF32 off.

``precision="fp8"`` is the control: every operand of a matrix product or
convolution is rounded to float8 e4m3 with one scale per tensor (the
straight-through rounding, so gradients flow), the rest stays float32.
It is the step below the configuration's bfloat16 that a later change
could be tempted to take.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.ops import resize_bicubic

FP8_MAX = 448.0


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    if precision != "fp8":
        raise ValueError(f"precision {precision!r}: f32 or fp8")
    scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


class Network:
    """The CoSA dual-task network of one configuration's widths."""

    def __init__(self, widths: Dict, num_classes: int, aux_layer: int,
                 precision: str = "f32"):
        self.d = widths["embed_dim"]
        self.depth = widths["depth"]
        self.heads = widths["num_heads"]
        self.patch = widths["patch_size"]
        self.base_grid = widths["base_img_size"] // self.patch
        self.ln_eps = widths["ln_eps"]
        self.dilation = widths["decoder_dilation"]
        self.num_classes = num_classes
        self.aux_layer = aux_layer
        self.precision = precision

    def _mm(self, x, w):
        p = self.precision
        return round_operand(x, p) @ round_operand(w, p)

    def _linear(self, x, w, name):
        y = self._mm(x, w[name + ".weight"].t())
        bias = w.get(name + ".bias")
        return y if bias is None else y + bias

    def _conv(self, x, weight, dilation):
        p = self.precision
        pad = dilation * (weight.shape[-1] // 2)
        return F.conv2d(round_operand(x, p), round_operand(weight, p),
                        padding=pad, dilation=dilation)

    def _ln(self, x, w, name):
        return F.layer_norm(x, (self.d,), w[name + ".weight"], w[name + ".bias"], self.ln_eps)

    def _attention(self, x, w, name):
        b, n, _ = x.shape
        hd = self.d // self.heads
        qkv = self._linear(x, w, name + ".qkv").reshape(b, n, 3, self.heads, hd)
        q, k, v = qkv.unbind(2)
        s = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v).reshape(b, n, self.d)
        return self._linear(o, w, name + ".proj")

    def encoder(self, x, w):
        """x (B, H, W, 3) normalized -> (tokens, aux tokens), the patch tokens
        after the final norm and after block ``aux_layer``."""
        b, hh, ww, c = x.shape
        p, d = self.patch, self.d
        gh, gw = hh // p, ww // p
        x = x[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        wmat = w["encoder.patch_embed.proj.weight"].permute(2, 3, 1, 0).reshape(p * p * c, d)
        tok = self._mm(x.reshape(b, gh * gw, p * p * c), wmat) + w["encoder.patch_embed.proj.bias"]
        pos = w["encoder.pos_embed"]
        grid = pos[:, 1:].reshape(1, self.base_grid, self.base_grid, d)
        pos = torch.cat([pos[:, :1], resize_bicubic(grid, (gh, gw)).reshape(1, gh * gw, d)], 1)
        tok = torch.cat([w["encoder.cls_token"].expand(b, 1, d), tok], dim=1) + pos
        aux_idx = self.depth + self.aux_layer if self.aux_layer < 0 else self.aux_layer
        aux = None
        for i in range(self.depth):
            n = f"encoder.blocks.{i}"
            tok = tok + self._attention(self._ln(tok, w, n + ".norm1"), w, n + ".attn")
            h = F.gelu(self._linear(self._ln(tok, w, n + ".norm2"), w, n + ".mlp.fc1"))
            tok = tok + self._linear(h, w, n + ".mlp.fc2")
            if i == aux_idx:
                aux = tok
        tok = self._ln(tok, w, "encoder.norm")
        return tok[:, 1:], (tok if aux is None else aux)[:, 1:]

    def __call__(self, x, w) -> Dict[str, torch.Tensor]:
        """x (B, H, W, 3) normalized -> cls, cls_aux (B, C-1); seg (B, h, w, C);
        cam, cam_aux (B, h, w, C-1)."""
        b, hh, ww, _ = x.shape
        gh, gw = hh // self.patch, ww // self.patch
        tokens, aux = self.encoder(x, w)
        fmap = tokens.reshape(b, gh, gw, self.d)
        fmap_aux = aux.reshape(b, gh, gw, self.d)
        y = fmap.permute(0, 3, 1, 2)
        y = F.relu(self._conv(y, w["decoder.conv6.weight"], self.dilation))
        y = F.relu(self._conv(y, w["decoder.conv7.weight"], self.dilation))
        seg = self._conv(y, w["decoder.conv8.weight"], 1).permute(0, 2, 3, 1)
        wc = w["classifier.weight"][:, :, 0, 0].t()
        wa = w["aux_classifier.weight"][:, :, 0, 0].t()
        return dict(
            cls=self._mm(fmap.amax(dim=(1, 2)), wc),
            cls_aux=self._mm(fmap_aux.amax(dim=(1, 2)), wa),
            seg=seg,
            cam=self._mm(fmap, wc),
            cam_aux=self._mm(fmap_aux, wa),
        )


def weight_shapes(widths: Dict, num_classes: int) -> Dict[str, tuple]:
    """The published CoSA state dict's names and shapes for ``widths``."""
    d, p, m, e = widths["embed_dim"], widths["patch_size"], widths["mlp_dim"], widths["decoder_dim"]
    g = widths["base_img_size"] // p
    shapes = {"encoder.cls_token": (1, 1, d), "encoder.pos_embed": (1, g * g + 1, d),
              "encoder.patch_embed.proj.weight": (d, 3, p, p),
              "encoder.patch_embed.proj.bias": (d,)}
    for i in range(widths["depth"]):
        for name, shape in (("norm1.weight", (d,)), ("norm1.bias", (d,)),
                            ("attn.qkv.weight", (3 * d, d)), ("attn.qkv.bias", (3 * d,)),
                            ("attn.proj.weight", (d, d)), ("attn.proj.bias", (d,)),
                            ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                            ("mlp.fc1.weight", (m, d)), ("mlp.fc1.bias", (m,)),
                            ("mlp.fc2.weight", (d, m)), ("mlp.fc2.bias", (d,))):
            shapes[f"encoder.blocks.{i}.{name}"] = shape
    shapes.update({"encoder.norm.weight": (d,), "encoder.norm.bias": (d,),
                   "decoder.conv6.weight": (e, d, 3, 3), "decoder.conv7.weight": (e, e, 3, 3),
                   "decoder.conv8.weight": (num_classes, e, 1, 1),
                   "classifier.weight": (num_classes - 1, d, 1, 1),
                   "aux_classifier.weight": (num_classes - 1, d, 1, 1)})
    return shapes
