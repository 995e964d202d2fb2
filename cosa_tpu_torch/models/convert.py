"""JAX parameter tree -> the port's ``state_dict``, and the AugReg reader.

:func:`state_dict_from_jax` is the inverse of the JAX package's
``network_params_from_torch`` (cosa_tpu/models/convert.py:105-119), on a
tree of numpy arrays:

  encoder/patch_embed/kernel (P,P,3,D)  -> encoder.patch_embed.proj.weight (D,3,P,P)
  .../{qkv,proj,fc1,fc2}/kernel (in,out) -> ....weight (out,in)
  .../norm*/scale                        -> .../norm*.weight
  encoder/{cls,dist}_token               -> encoder.{cls,dist}_token
  decoder/convK/kernel (3,3,I,O) HWIO    -> decoder.convK.weight (O,I,3,3) OIHW
  decoder/blocks_i/{qkv,proj,fc1,fc2}    -> decoder.blocks.i.{attn.qkv,attn.proj,mlp.fc1,mlp.fc2}
  decoder/{proj_patch,proj_classes,cls_emb} -> the same names, as stored
  classifier (D, C-1)                    -> classifier.weight (C-1, D, 1, 1)

The keys are the reference's, so a CoSA ``.pth`` (LargeFOV or Maskformer)
also loads with plain ``load_state_dict``. A zoo model's tree (its modules
carry the JAX names) converts leaf by leaf, params and ``batch_stats``.
:func:`load_pretrained_into_state` loads a reference-key or a timm-key
``.pth``, or an original AugReg ``.npz`` (:func:`state_dict_from_augreg_npz`),
an mmseg Swin ``.pth`` (:func:`state_dict_from_mmseg_swin`) or an NVlabs
SegFormer ``.pth`` (:func:`state_dict_from_segformer`) into the student
and the teacher of a training state.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from cosa_tpu_torch.models.vit import BACKBONES


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(prefix: str, p: Dict[str, Any], out: Dict[str, torch.Tensor]) -> None:
    out[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])


def _norm(prefix: str, p: Dict[str, Any], out: Dict[str, torch.Tensor]) -> None:
    out[prefix + ".weight"] = _t(p["scale"])
    out[prefix + ".bias"] = _t(p["bias"])


def _zoo_state_dict(params: Dict[str, Any],
                    batch_stats: Optional[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """A zoo model's tree: the port's modules carry the JAX tree's names,
    so each leaf only changes its name and layout (``kernel`` -> ``weight``,
    Dense transposed, Conv HWIO -> OIHW; ``scale`` -> ``weight``; the CAM
    classifiers (D, C-1) -> (C-1, D, 1, 1); ``batch_stats`` ``mean``/``var``
    -> ``running_mean``/``running_var``; ``rel_pos_bias`` as stored)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix, stats):
        for k, v in tree.items():
            name = prefix + k
            if isinstance(v, dict):
                walk(v, name + ".", stats)
                continue
            a = np.asarray(v)
            if stats:
                sd[prefix + {"mean": "running_mean", "var": "running_var"}[k]] = _t(a)
            elif k == "kernel":
                sd[prefix + "weight"] = _t(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T)
            elif k == "scale":
                sd[prefix + "weight"] = _t(a)
            elif name in ("classifier", "aux_classifier"):
                sd[name + ".weight"] = _t(a.T[:, :, None, None])
            else:
                sd[name] = _t(a)

    walk(params, "", False)
    walk(batch_stats or {}, "", True)
    return sd


def state_dict_from_jax(params: Dict[str, Any],
                        batch_stats: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, torch.Tensor]:
    """The port's state dict of a JAX ``params`` tree (and, for the zoo's
    BatchNorm families, its ``batch_stats``): CoSANetwork's by the table
    above, a zoo model's by :func:`_zoo_state_dict`."""
    if "cls_token" not in params.get("encoder", {}):
        return _zoo_state_dict(params, batch_stats)
    enc = params["encoder"]
    sd: Dict[str, torch.Tensor] = {
        "encoder.patch_embed.proj.weight": _t(
            np.asarray(enc["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)),
        "encoder.patch_embed.proj.bias": _t(enc["patch_embed"]["bias"]),
        "encoder.cls_token": _t(enc["cls_token"]),
        "encoder.pos_embed": _t(enc["pos_embed"]),
    }
    if "dist_token" in enc:
        sd["encoder.dist_token"] = _t(enc["dist_token"])
    i = 0
    while f"blocks_{i}" in enc:
        blk, pre = enc[f"blocks_{i}"], f"encoder.blocks.{i}."
        _norm(pre + "norm1", blk["norm1"], sd)
        _norm(pre + "norm2", blk["norm2"], sd)
        _dense(pre + "attn.qkv", blk["attn"]["qkv"], sd)
        _dense(pre + "attn.proj", blk["attn"]["proj"], sd)
        _dense(pre + "mlp.fc1", blk["mlp"]["fc1"], sd)
        _dense(pre + "mlp.fc2", blk["mlp"]["fc2"], sd)
        i += 1
    _norm("encoder.norm", enc["norm"], sd)
    dec = params["decoder"]
    if "cls_emb" in dec:  # MaskTransformer
        _dense("decoder.proj_dec", dec["proj_dec"], sd)
        for name in ("cls_emb", "proj_patch", "proj_classes"):
            sd["decoder." + name] = _t(dec[name])
        _norm("decoder.decoder_norm", dec["decoder_norm"], sd)
        _norm("decoder.mask_norm", dec["mask_norm"], sd)
        i = 0
        while f"blocks_{i}" in dec:
            blk, pre = dec[f"blocks_{i}"], f"decoder.blocks.{i}."
            _norm(pre + "norm1", blk["norm1"], sd)
            _norm(pre + "norm2", blk["norm2"], sd)
            _dense(pre + "attn.qkv", blk["qkv"], sd)
            _dense(pre + "attn.proj", blk["proj"], sd)
            _dense(pre + "mlp.fc1", blk["fc1"], sd)
            _dense(pre + "mlp.fc2", blk["fc2"], sd)
            i += 1
    else:  # LargeFOV
        for k in (6, 7, 8):
            sd[f"decoder.conv{k}.weight"] = _t(
                np.asarray(dec[f"conv{k}"]["kernel"]).transpose(3, 2, 0, 1))
    for name in ("classifier", "aux_classifier"):
        sd[name + ".weight"] = _t(np.asarray(params[name]).T[:, :, None, None])
    return sd


def state_dict_from_augreg_npz(path: str, depth: int = 12) -> Dict[str, torch.Tensor]:
    """A timm-key ViT encoder state dict from an original google-research
    vision_transformer / AugReg ``.npz`` (the upstream of the timm
    ``jx_vit_*`` weights the reference downloads; the JAX package's
    ``encoder_params_from_augreg_npz``, models/convert.py:142-188):

      embedding/kernel (P,P,3,D) HWIO          -> patch_embed.proj.weight (D,3,P,P)
      .../{query,key,value}/kernel (D,H,hd)    -> blocks.i.attn.qkv.weight (3D, D)
      .../out/kernel (H,hd,D)                  -> blocks.i.attn.proj.weight (D, D)
      LayerNorm_0 / LayerNorm_2                -> norm1 / norm2
      MlpBlock_3/Dense_0 / Dense_1             -> mlp.fc1 / mlp.fc2"""
    with np.load(path) as z:
        def g(k):
            return np.asarray(z[k], np.float32)

        d = g("embedding/bias").shape[0]
        sd = {
            "patch_embed.proj.weight": _t(g("embedding/kernel").transpose(3, 2, 0, 1)),
            "patch_embed.proj.bias": _t(g("embedding/bias")),
            "cls_token": _t(g("cls")),
            "pos_embed": _t(g("Transformer/posembed_input/pos_embedding")),
            "norm.weight": _t(g("Transformer/encoder_norm/scale")),
            "norm.bias": _t(g("Transformer/encoder_norm/bias")),
        }
        for i in range(depth):
            b, pre = f"Transformer/encoderblock_{i}/", f"blocks.{i}."
            att = b + "MultiHeadDotProductAttention_1/"
            qkv = ("query", "key", "value")
            sd[pre + "attn.qkv.weight"] = _t(np.concatenate(
                [g(att + f"{n}/kernel").reshape(d, -1) for n in qkv], axis=1).T)
            sd[pre + "attn.qkv.bias"] = _t(np.concatenate(
                [g(att + f"{n}/bias").reshape(-1) for n in qkv]))
            sd[pre + "attn.proj.weight"] = _t(g(att + "out/kernel").reshape(-1, d).T)
            sd[pre + "attn.proj.bias"] = _t(g(att + "out/bias"))
            for k, name in (("0", "norm1"), ("2", "norm2")):
                sd[pre + name + ".weight"] = _t(g(b + f"LayerNorm_{k}/scale"))
                sd[pre + name + ".bias"] = _t(g(b + f"LayerNorm_{k}/bias"))
            for k, name in (("0", "fc1"), ("1", "fc2")):
                sd[pre + f"mlp.{name}.weight"] = _t(g(b + f"MlpBlock_3/Dense_{k}/kernel").T)
                sd[pre + f"mlp.{name}.bias"] = _t(g(b + f"MlpBlock_3/Dense_{k}/bias"))
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict, read with ``weights_only=True``; a CoSA
    ``best_*.pth`` container's ``model`` entry."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd["model"] if "model" in sd else sd


def state_dict_from_mmseg_swin(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ``SwinBackbone`` state dict from an mmseg/mmcv Swin checkpoint (the
    weights the reference's MMSWIN/MMSegModel wrappers load; the JAX
    package's ``swin_params_from_mmseg``, models/convert.py:191-242). Keys
    with or without mmseg's ``backbone.`` prefix; the layouts are torch's
    on both sides, so only the names change:

      patch_embed.projection / patch_embed.norm -> patch_embed / patch_norm
      stages.I.blocks.J.norm{1,2}               -> stageI_blockJ.norm{1,2}
      ...attn.w_msa.{qkv,proj}                  -> ...attn.{qkv,proj}
      ...attn.w_msa.relative_position_bias_table -> ...attn.rel_pos_bias
      ...ffn.layers.0.0 / ffn.layers.1          -> ...fc1 / fc2
      stages.I.downsample.{norm,reduction}      -> mergeI.{norm,reduction}
      normI                                     -> normI

    ``relative_position_index`` is dropped: the port recomputes that
    constant with the same formula."""
    if any(k.startswith("backbone.") for k in sd):
        sd = {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
    rules = ((r"^patch_embed\.projection\.", "patch_embed."),
             (r"^patch_embed\.norm\.", "patch_norm."),
             (r"^stages\.(\d+)\.blocks\.(\d+)\.", r"stage\1_block\2."),
             (r"^stages\.(\d+)\.downsample\.", r"merge\1."),
             (r"\.attn\.w_msa\.relative_position_bias_table$", ".attn.rel_pos_bias"),
             (r"\.attn\.w_msa\.", ".attn."),
             (r"\.ffn\.layers\.0\.0\.", ".fc1."),
             (r"\.ffn\.layers\.1\.", ".fc2."))
    out = {}
    for k, v in sd.items():
        if k.endswith("relative_position_index"):
            continue
        for pat, rep in rules:
            k = re.sub(pat, rep, k)
        out[k] = v
    return out


def state_dict_from_segformer(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A ``MixVisionTransformer`` state dict from an official SegFormer
    (NVlabs) checkpoint (the module the reference vendors at
    models/vit/mix_transformer.py:18-378; the JAX package's
    ``mit_params_from_torch``, models/convert.py:245-292). Stages s = 1..4:

      patch_embed{s}.proj / patch_embed{s}.norm -> patch_embed{s} / patch_norm{s}
      block{s}.J.attn.{q,kv,proj,sr}            -> block{s}_J.attn.{q,kv,proj,sr}
      block{s}.J.attn.norm                      -> block{s}_J.attn.sr_norm
      block{s}.J.mlp.dwconv.dwconv              -> block{s}_J.mlp.dwconv
      norm{s}, block{s}.J.{norm1,norm2,mlp.fc1,mlp.fc2}: the same

    The head's keys (``head.*``, a classifier's) are dropped by the loader,
    as keys the network lacks."""
    rules = ((r"^patch_embed(\d)\.proj\.", r"patch_embed\1."),
             (r"^patch_embed(\d)\.norm\.", r"patch_norm\1."),
             (r"^block(\d)\.(\d+)\.", r"block\1_\2."),
             (r"\.attn\.norm\.", ".attn.sr_norm."),
             (r"\.mlp\.dwconv\.dwconv\.", ".mlp.dwconv."))
    out = {}
    for k, v in sd.items():
        for pat, rep in rules:
            k = re.sub(pat, rep, k)
        out[k] = v
    return out


def load_pretrained_into_state(cfg, state):
    """Load ``cfg.pretrained_path`` into student AND teacher (the reference
    builds both networks on the same pretrained backbone, main.py:45-46), as
    the JAX package's loader does (models/convert.py:318-354):

      model 'vit'          a reference-key ``.pth`` (``encoder.*`` plus
                           heads), a timm-key encoder ``.pth`` or an AugReg
                           ``.npz``;
      model 'swinend2end'  an mmseg/mmcv Swin ``.pth`` (the backbone);
      model 'segformer'    an official SegFormer (NVlabs) ``.pth`` (the encoder).

    Keys the network does not have are dropped (``strict=False``, the JAX
    package's ``_filter_to``: e.g. an mmseg file's norm0-norm2, where
    SwinNetwork builds norm3 only); every backbone tensor of the network
    must be in the file, else ``KeyError``. Returns ``state``."""
    path = cfg.pretrained_path
    if cfg.model == "swinend2end":
        prefix = "backbone."
        sd = {prefix + k: v for k, v in
              state_dict_from_mmseg_swin(load_torch_checkpoint(path)).items()}
    elif cfg.model == "segformer":
        prefix = "encoder."
        sd = {prefix + k: v for k, v in
              state_dict_from_segformer(load_torch_checkpoint(path)).items()}
    elif cfg.model == "vit":
        prefix = "encoder."
        if path.endswith(".npz"):
            sd = state_dict_from_augreg_npz(path, BACKBONES[cfg.backbone].depth)
        else:
            sd = load_torch_checkpoint(path)
        if not any(k.startswith(prefix) for k in sd):
            sd = {prefix + k: v for k, v in sd.items()}  # timm's encoder keys
    else:
        raise NotImplementedError(
            f"pretrained weights for model '{cfg.model}': the JAX package loads "
            "files for 'vit', 'swinend2end' and 'segformer' only")
    own = state.student.state_dict()
    sd = {k: v for k, v in sd.items() if k in own}
    missing = sorted(k for k in own if k.startswith(prefix) and k not in sd)
    if missing:
        raise KeyError(f"{path} lacks {prefix[:-1]} weights: {missing[:4]}")
    for model in (state.student, state.teacher):
        model.load_state_dict(sd, strict=False)
    return state
