"""The CoSA dual-task network: ViT encoder + seg decoder (LargeFOV or
MaskTransformer) + CAM/cls heads (reference ``VITNetwork``,
models/__init__.py:82-206; the JAX package's models/network.py).

  * two bias-free 1x1 CAM classifiers over the last / aux feature maps,
    applied as (D, C-1) matmuls on NHWC maps;
  * the same classifier weights give the image-level logits through a
    global max pool;
  * a 4-way ``detach`` switch routes gradients around the CAM branch.

Outputs are a dict; all maps are NHWC.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn

from cosa_tpu_torch.models.decoders import LargeFOV, MaskTransformer
from cosa_tpu_torch.models.vit import BACKBONES, VisionTransformer
from cosa_tpu_torch.utils.device import resolve_device


class CoSANetwork(nn.Module):
    def __init__(self, num_classes: int, backbone: str = "vit_base_patch16_224",
                 decoder: str = "LargeFOV", aux_layer: int = -3,
                 isgap: bool = False, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False):
        super().__init__()
        cfg = BACKBONES[backbone]
        self.isgap = isgap
        self.dtype = dtype
        d = cfg.embed_dim
        self.encoder = VisionTransformer(cfg, aux_layer, dtype, use_kernel)
        if decoder == "LargeFOV":
            self.decoder = LargeFOV(d, num_classes, dtype=dtype)
        elif decoder == "Maskformer":
            self.decoder = MaskTransformer(num_classes, cfg.patch_size, d, d, dtype=dtype)
        else:
            raise ValueError(f"decoder {decoder!r}: LargeFOV or Maskformer")
        self.classifier = nn.Conv2d(d, num_classes - 1, 1, bias=False)
        self.aux_classifier = nn.Conv2d(d, num_classes - 1, 1, bias=False)

    def forward(self, x: torch.Tensor, detach: str = "none") -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) normalized image.

        Returns cls, cls_aux (B, C-1); feat (B, h, w, D); seg (B, h, w, C);
        cam, cam_aux (B, h, w, C-1). seg/cam/cls are f32."""
        b, hh, ww, _ = x.shape
        p = self.encoder.cfg.patch_size
        gh, gw = hh // p, ww // p
        _, tokens, aux_tokens = self.encoder(x)
        d = tokens.shape[-1]
        fmap = tokens.reshape(b, gh, gw, d)
        fmap_aux = aux_tokens.reshape(b, gh, gw, d)
        if isinstance(self.decoder, MaskTransformer):  # the normed patch tokens
            seg = self.decoder(tokens, (hh, ww))
        else:
            seg = self.decoder(fmap)

        return cosa_heads(fmap, fmap_aux, seg, self.classifier, self.aux_classifier,
                          self.dtype, detach, self.isgap)


def cosa_heads(fmap: torch.Tensor, fmap_aux: torch.Tensor, seg: torch.Tensor,
               classifier: nn.Conv2d, aux_classifier: nn.Conv2d, dtype: torch.dtype,
               detach: str, isgap: bool) -> Dict[str, torch.Tensor]:
    """The CoSA output dict from the feature maps and the seg logits: the
    CAMs of the two bias-free 1x1 classifiers (routed by ``detach``) and
    their global max (``isgap``: mean) pooled image-level logits. Shared by
    CoSANetwork and the zoo's SwinNetwork."""
    assert detach in ("all", "feat", "none", "cls")
    wc = classifier.weight[:, :, 0, 0].t().to(dtype)
    wa = aux_classifier.weight[:, :, 0, 0].t().to(dtype)
    if detach == "all":
        cam, cam_aux = (fmap @ wc).detach(), (fmap_aux @ wa).detach()
    elif detach == "feat":
        cam, cam_aux = fmap.detach() @ wc, fmap_aux.detach() @ wa
    elif detach == "cls":
        cam, cam_aux = fmap @ wc.detach(), fmap_aux @ wa.detach()
    else:
        cam, cam_aux = fmap @ wc, fmap_aux @ wa

    if isgap:
        pooled, pooled_aux = fmap.mean(dim=(1, 2)), fmap_aux.mean(dim=(1, 2))
    else:
        pooled, pooled_aux = fmap.amax(dim=(1, 2)), fmap_aux.amax(dim=(1, 2))
    f32 = torch.float32
    return dict(
        cls=(pooled @ wc).to(f32),
        cls_aux=(pooled_aux @ wa).to(f32),
        feat=fmap,
        seg=seg.to(f32),
        cam=cam.to(f32),
        cam_aux=cam_aux.to(f32),
    )


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in the JAX package's scheme: LeCun-normal
    (truncated at 2 std) dense and conv weights, zero biases, LayerNorms and
    BatchNorms at scale 1 and bias 0 (their running mean and variance
    start at 0 and 1), truncated N(0, 0.02) class, distillation and
    class-embedding tokens, position embedding and Swin's relative-position
    bias tables, and the MaskTransformer's two projection matrices
    N(0, d_model^-0.5), untruncated (models/decoders.py:141-152)."""
    norms = {n for n, m in model.named_modules()
             if isinstance(m, nn.LayerNorm) or hasattr(m, "running_mean")}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("cls_token", "dist_token", "pos_embed", "cls_emb",
                              "rel_pos_bias")):
                std = 0.02
            elif name.endswith(("proj_patch", "proj_classes")):
                p.normal_(0.0, p.shape[0] ** -0.5, generator=generator)
                continue
            elif name.rpartition(".")[0] in norms:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
                continue
            elif name.endswith("bias"):
                p.zero_()
                continue
            else:
                fan_in = p[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)


def require_cosa_interface(cfg) -> None:
    """The co-training and evaluation pipelines need the full CoSA output
    dict (cls/cls_aux/seg/cam/cam_aux). Only 'vit' and 'swinend2end' give
    it; the seg-only zoo families (res38, mmseg, segformer) are library
    use, as in the reference, whose factory branches for them are
    commented out. The entry points fail here, not deep in the step."""
    if cfg.model not in ("vit", "swinend2end"):
        raise NotImplementedError(
            f"model '{cfg.model}' is a seg-only zoo family (library use: "
            "cosa_tpu_torch.models.zoo); the co-training and evaluation pipelines "
            "need the CoSA interface: use model 'vit' or 'swinend2end'"
        )


def build_model(cfg, device=None, seed: Optional[int] = None) -> nn.Module:
    """The network of ``cfg`` on ``device`` (default: the GPU), with a
    seeded random init (``seed`` defaults to ``cfg.seed``): CoSANetwork for
    'vit', the zoo's model (``build_zoo_model``) for every other family."""
    dev = resolve_device(device)
    if cfg.model == "vit":
        model = CoSANetwork(
            num_classes=cfg.num_classes,
            backbone=cfg.backbone,
            decoder=cfg.decoder,
            aux_layer=cfg.aux_layer,
            isgap=cfg.isgap,
            dtype=torch.bfloat16 if cfg.mixed_precision else torch.float32,
            use_kernel=bool(cfg.flash_attention),
        )
    else:
        from cosa_tpu_torch.models.zoo import build_zoo_model

        model = build_zoo_model(cfg)
    g = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    init_params(model, g)
    return model.to(dev)
