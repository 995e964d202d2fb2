"""The model zoo: every non-ViT family, PyTorch.

Port of the JAX package's models/zoo (the reference's vestigial families
behind its commented-out factory branches, models/__init__.py:25-75),
dispatched by :func:`build_zoo_model` with the same ``model``/``backbone``
vocabulary:

  model='res38'        backbone: res38 | beco_r101 | l2g_r101 | l2g_r101_v2
  model='mmseg'        backbone: uper-swin-{t,s,b} | deeplab3 | deeplab3p
  model='swinend2end'  backbone: swin-{t,s,b}     (the full CoSA interface)
  model='segformer'    backbone: mit_b0..mit_b5   (MiT + SegFormerHead)

Every model takes NHWC images and returns NHWC maps; the seg-only
families take ``train`` (batch statistics, live dropout) and a dropout
``generator`` in their forward.
"""

from __future__ import annotations

import torch

from cosa_tpu_torch.models.zoo.deeplab import (
    ASPPv2,
    ASPPv3,
    BECODeepLabV3Plus,
    DeepLabV1,
    DeepLabV1LargeFOV,
    DeepLabV1VGG16,
    DeepLabV2,
    DeepLabV2VGG16,
    DeepLabV3,
    DeepLabV3Plus,
    DepthwiseSeparableConv,
    FOVHead,
    MSC,
    SepASPP,
)
from cosa_tpu_torch.models.zoo.mit import (
    MIT_CONFIGS,
    MixVisionTransformer,
    SegFormer,
    SegFormerHead,
)
from cosa_tpu_torch.models.zoo.mmseg import (
    ASPPHead,
    FCNHead,
    MMSegDeepLab3,
    SepASPPHead,
    UPerHead,
    UPerSwin,
)
from cosa_tpu_torch.models.zoo.resnet import ResNetD
from cosa_tpu_torch.models.zoo.resnet38 import WRN38Cls, WRN38Seg
from cosa_tpu_torch.models.zoo.swin import SWIN_CONFIGS, SwinBackbone, SwinNetwork

__all__ = [
    "ASPPHead", "ASPPv2", "ASPPv3", "BECODeepLabV3Plus", "DeepLabV1",
    "DeepLabV1LargeFOV", "DeepLabV1VGG16", "DeepLabV2", "DeepLabV2VGG16",
    "DeepLabV3", "DeepLabV3Plus", "DepthwiseSeparableConv", "FCNHead",
    "FOVHead", "MIT_CONFIGS", "MMSegDeepLab3", "MSC", "MixVisionTransformer",
    "ResNetD", "SWIN_CONFIGS", "SegFormer", "SegFormerHead", "SepASPP",
    "SepASPPHead", "SwinBackbone", "SwinNetwork", "UPerHead", "UPerSwin",
    "WRN38Cls", "WRN38Seg", "build_zoo_model",
]


def build_zoo_model(cfg) -> torch.nn.Module:
    """The zoo model of ``cfg`` (unseeded: ``models/network.py::build_model``
    initializes it), with the reference's commented factory branches'
    dispatch (models/__init__.py:26-75). ``model='vit'`` stays in
    ``build_model``."""
    dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
    n = cfg.num_classes
    if cfg.model == "res38":
        if cfg.backbone == "res38":
            return WRN38Seg(n, dtype=dtype)
        if cfg.backbone == "beco_r101":
            return BECODeepLabV3Plus(n, dtype=dtype)
        if cfg.backbone == "l2g_r101":
            return DeepLabV1LargeFOV(n, dtype=dtype)
        if cfg.backbone == "l2g_r101_v2":
            return DeepLabV2(n, dtype=dtype)
        raise NotImplementedError(f"res38 backbone {cfg.backbone}")
    if cfg.model == "mmseg":
        if cfg.backbone.startswith("uper-swin"):
            return UPerSwin(n, cfg.backbone.replace("uper-", ""), dtype=dtype)
        if cfg.backbone == "deeplab3":
            return MMSegDeepLab3(n, dtype=dtype)
        if cfg.backbone == "deeplab3p":
            return MMSegDeepLab3(n, separable=True, dtype=dtype)
        raise NotImplementedError(f"mmseg backbone {cfg.backbone}")
    if cfg.model == "swinend2end":
        return SwinNetwork(n, cfg.backbone, aux_layer=cfg.aux_layer, isgap=cfg.isgap,
                           dtype=dtype)
    if cfg.model == "segformer":
        return SegFormer(n, cfg.backbone, dtype=dtype)
    raise NotImplementedError(f"model {cfg.model}")
