"""JAX parameter tree -> the port's ``state_dict``.

The inverse of the JAX package's ``network_params_from_torch``
(cosa_tpu/models/convert.py:105-119), on a tree of numpy arrays:

  encoder/patch_embed/kernel (P,P,3,D)  -> encoder.patch_embed.proj.weight (D,3,P,P)
  .../{qkv,proj,fc1,fc2}/kernel (in,out) -> ....weight (out,in)
  .../norm*/scale                        -> .../norm*.weight
  decoder/convK/kernel (3,3,I,O) HWIO    -> decoder.convK.weight (O,I,3,3) OIHW
  classifier (D, C-1)                    -> classifier.weight (C-1, D, 1, 1)

The keys are the reference's, so a CoSA ``.pth`` also loads with plain
``load_state_dict``.
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
