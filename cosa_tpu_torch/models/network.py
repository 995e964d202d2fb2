"""The CoSA dual-task network: ViT encoder + LargeFOV decoder + CAM/cls
heads (reference ``VITNetwork``, models/__init__.py:82-206; the JAX
package's models/network.py).

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

from cosa_tpu_torch.models.decoders import LargeFOV
from cosa_tpu_torch.models.vit import BACKBONES, VisionTransformer
from cosa_tpu_torch.utils.device import resolve_device


class CoSANetwork(nn.Module):
    def __init__(self, num_classes: int, backbone: str = "vit_base_patch16_224",
                 decoder: str = "LargeFOV", aux_layer: int = -3,
                 isgap: bool = False, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False):
        super().__init__()
        if decoder != "LargeFOV":
            raise NotImplementedError(
                f"decoder '{decoder}': the MaskTransformer decoder is ROADMAP "
                "Queue 1 item 17"
            )
        cfg = BACKBONES[backbone]
        self.isgap = isgap
        self.dtype = dtype
        d = cfg.embed_dim
        self.encoder = VisionTransformer(cfg, aux_layer, dtype, use_kernel)
        self.decoder = LargeFOV(d, num_classes, dtype=dtype)
        self.classifier = nn.Conv2d(d, num_classes - 1, 1, bias=False)
        self.aux_classifier = nn.Conv2d(d, num_classes - 1, 1, bias=False)

    def forward(self, x: torch.Tensor, detach: str = "none") -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) normalized image.

        Returns cls, cls_aux (B, C-1); feat (B, h, w, D); seg (B, h, w, C);
        cam, cam_aux (B, h, w, C-1). seg/cam/cls are f32."""
        assert detach in ("all", "feat", "none", "cls")
        b, hh, ww, _ = x.shape
        p = self.encoder.cfg.patch_size
        gh, gw = hh // p, ww // p
        _, tokens, aux_tokens = self.encoder(x)
        d = tokens.shape[-1]
        fmap = tokens.reshape(b, gh, gw, d)
        fmap_aux = aux_tokens.reshape(b, gh, gw, d)
        seg = self.decoder(fmap)

        wc = self.classifier.weight[:, :, 0, 0].t().to(self.dtype)
        wa = self.aux_classifier.weight[:, :, 0, 0].t().to(self.dtype)
        if detach == "all":
            cam, cam_aux = (fmap @ wc).detach(), (fmap_aux @ wa).detach()
        elif detach == "feat":
            cam, cam_aux = fmap.detach() @ wc, fmap_aux.detach() @ wa
        elif detach == "cls":
            cam, cam_aux = fmap @ wc.detach(), fmap_aux @ wa.detach()
        else:
            cam, cam_aux = fmap @ wc, fmap_aux @ wa

        if self.isgap:
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
    (truncated at 2 std) weights, zero biases, unit LayerNorms and
    truncated N(0, 0.02) class token and position embedding."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("cls_token", "pos_embed")):
                std = 0.02
            elif ".norm" in name:
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
    """The co-training pipeline needs the full CoSA output dict. The port
    has the 'vit' family only; the zoo is ROADMAP Queue 1 item 19."""
    if cfg.model != "vit":
        raise NotImplementedError(
            f"model '{cfg.model}': the PyTorch port builds 'vit' only; the "
            "model zoo is ROADMAP Queue 1 item 19"
        )


def build_model(cfg, device=None, seed: Optional[int] = None) -> CoSANetwork:
    """CoSANetwork for ``cfg`` on ``device`` (default: the GPU), with a
    seeded random init (``seed`` defaults to ``cfg.seed``)."""
    require_cosa_interface(cfg)
    dev = resolve_device(device)
    model = CoSANetwork(
        num_classes=cfg.num_classes,
        backbone=cfg.backbone,
        decoder=cfg.decoder,
        aux_layer=cfg.aux_layer,
        isgap=cfg.isgap,
        dtype=torch.bfloat16 if cfg.mixed_precision else torch.float32,
        use_kernel=bool(cfg.flash_attention),
    )
    g = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    init_params(model, g)
    return model.to(dev)
