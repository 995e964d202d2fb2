"""JAX parameter tree -> the port's ``state_dict``.

The inverse of the JAX package's ``network_params_from_torch``
(cosa_tpu/models/convert.py:105-119), on a tree of numpy arrays:

  encoder/patch_embed/kernel (P,P,3,D)  -> encoder.patch_embed.proj.weight (D,3,P,P)
  .../{qkv,proj,fc1,fc2}/kernel (in,out) -> ....weight (out,in)
  .../norm*/scale                        -> .../norm*.weight
  decoder/convK/kernel (3,3,I,O) HWIO    -> decoder.convK.weight (O,I,3,3) OIHW
  classifier (D, C-1)                    -> classifier.weight (C-1, D, 1, 1)

The keys are the reference's, so a CoSA ``.pth`` also loads with plain
``load_state_dict``. :func:`load_pretrained_into_state` loads a
reference-key or a timm-key ``.pth`` into the student and the teacher of a
training state.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(prefix: str, p: Dict[str, Any], out: Dict[str, torch.Tensor]) -> None:
    out[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])


def _norm(prefix: str, p: Dict[str, Any], out: Dict[str, torch.Tensor]) -> None:
    out[prefix + ".weight"] = _t(p["scale"])
    out[prefix + ".bias"] = _t(p["bias"])


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    enc = params["encoder"]
    sd: Dict[str, torch.Tensor] = {
        "encoder.patch_embed.proj.weight": _t(
            np.asarray(enc["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)),
        "encoder.patch_embed.proj.bias": _t(enc["patch_embed"]["bias"]),
        "encoder.cls_token": _t(enc["cls_token"]),
        "encoder.pos_embed": _t(enc["pos_embed"]),
    }
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
    for k in (6, 7, 8):
        sd[f"decoder.conv{k}.weight"] = _t(
            np.asarray(params["decoder"][f"conv{k}"]["kernel"]).transpose(3, 2, 0, 1))
    for name in ("classifier", "aux_classifier"):
        sd[name + ".weight"] = _t(np.asarray(params[name]).T[:, :, None, None])
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict, read with ``weights_only=True``; a CoSA
    ``best_*.pth`` container's ``model`` entry."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd["model"] if "model" in sd else sd


def load_pretrained_into_state(cfg, state):
    """Load ``cfg.pretrained_path`` into student AND teacher (the reference
    builds both networks on the same pretrained backbone, main.py:45-46), as
    the JAX package's loader for ``model="vit"`` (models/convert.py:318-354):
    a reference-key ``.pth`` (``encoder.*`` plus heads) or a timm-key encoder
    ``.pth``. Keys the network does not have are dropped (``strict=False``,
    the JAX package's ``_filter_to``); every encoder tensor of the network
    must be in the file. Returns ``state``."""
    path = cfg.pretrained_path
    if cfg.model != "vit":
        raise NotImplementedError(
            f"pretrained weights for model '{cfg.model}': the model zoo and its "
            "loaders are ROADMAP Queue 1 items 16 and 19")
    if path.endswith(".npz"):
        raise NotImplementedError(
            "an AugReg .npz checkpoint: its loader is ROADMAP Queue 1 item 16")
    sd = load_torch_checkpoint(path)
    if not any(k.startswith("encoder.") for k in sd):
        sd = {"encoder." + k: v for k, v in sd.items()}  # timm's encoder keys
    own = state.student.state_dict()
    sd = {k: v for k, v in sd.items() if k in own}
    missing = sorted(k for k in own if k.startswith("encoder.") and k not in sd)
    if missing:
        raise KeyError(f"{path} lacks encoder weights: {missing[:4]}")
    for model in (state.student, state.teacher):
        model.load_state_dict(sd, strict=False)
    return state
