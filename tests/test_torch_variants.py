"""PyTorch port vs the JAX package: the rest of the ViT family.

The distilled DeiT encoder, the MaskTransformer decoder (single and
``multi``), the CoSA network with the Maskformer decoder, the AugReg
``.npz`` loader, ``state_dict_from_jax`` round trips and ``init_params``
for the new parameters. JAX parameters from a seeded ``init`` are carried
into the port with ``state_dict_from_jax`` (or the ``.npz`` read by both
packages' loaders); the same numpy inputs go through both.

Tolerances: f32 encoder and decoder outputs within 1e-5 of each output's
largest magnitude; the Maskformer network's f32 outputs within rtol/atol
2e-4 (test_torch_model.py's bound for the whole network, whose position
embedding is resized at the non-square sizes); converted tensors equal.
No bf16 case: the mask head's LayerNorm over the class axis divides
cosines of nearly equal class features by their small spread, so bf16's
step near 1 (2^-8) becomes 3-8% of the seg range at random init, in both
packages alike."""

from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.models import build_model as jax_build_model
from cosa_tpu.models.convert import (
    encoder_params_from_augreg_npz,
    network_params_from_torch,
)
from cosa_tpu.models.decoders import MaskTransformer as JaxMaskTransformer
from cosa_tpu.models.vit import BACKBONES as JAX_BACKBONES
from cosa_tpu.models.vit import VisionTransformer as JaxViT
from cosa_tpu.train.optimizer import param_label as jax_param_label
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.models.convert import (
    load_pretrained_into_state,
    state_dict_from_augreg_npz,
    state_dict_from_jax,
)
from cosa_tpu_torch.models.network import CoSANetwork, init_params
from cosa_tpu_torch.models.vit import BACKBONES, VisionTransformer
from cosa_tpu_torch.train.optimizer import param_label
from cosa_tpu_torch.train.state import create_train_state

KEYS = ("cls", "cls_aux", "seg", "cam", "cam_aux")
DISTILLED = "deit_tiny_test_distilled"


def _np(t):
    return jax.tree.map(np.asarray, t)


def _close(ours, ref, rel=1e-5, what=""):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, what
    assert np.abs(ours - ref).max() <= rel * np.abs(ref).max(), what


def _pair(backbone, decoder, mixed_precision=False, seed=0):
    cfg = jax_preset("synthetic", backbone=backbone, decoder=decoder, num_classes=6,
                     mixed_precision=mixed_precision, flash_attention=False, aux_layer=-2)
    jm = jax_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))["params"]
    tm = CoSANetwork(6, backbone, decoder=decoder, aux_layer=-2,
                     dtype=torch.bfloat16 if mixed_precision else torch.float32,
                     use_kernel=True)  # on a CPU tensor: the plain version
    tm.load_state_dict(state_dict_from_jax(_np(params)))
    return jm, params, tm.eval()


@pytest.mark.parametrize("hw", [(64, 64), (80, 96)])
def test_distilled_encoder_matches_jax(hw):
    """CLS token (the second prefix token), patch tokens and aux tokens."""
    _, params, tm = _pair(DISTILLED, "LargeFOV")
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = JaxViT(JAX_BACKBONES[DISTILLED], aux_layer=-2).apply(
        {"params": params["encoder"]}, jnp.asarray(x))
    with torch.no_grad():
        ours = tm.encoder(torch.from_numpy(x))
    assert tm.encoder.pos_embed.shape[1] == (64 // 16) ** 2 + 2
    for name, a, b in zip(("cls", "tokens", "aux"), ours, ref):
        _close(a.numpy(), b, what=name)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_mask_transformer_matches_jax(multi):
    """The decoder alone on the same patch tokens; ``multi`` returns the
    penultimate and the final block's masks through the shared head."""
    _, params, tm = _pair("vit_tiny_test", "Maskformer")
    b, gh, gw, d = 2, 4, 5, 64
    tok = np.random.default_rng(2).standard_normal((b, gh * gw, d)).astype(np.float32)
    ref = JaxMaskTransformer(n_cls=6, patch_size=16, d_model=d, multi=multi).apply(
        {"params": params["decoder"]}, jnp.asarray(tok), (gh * 16, gw * 16))
    tm.decoder.multi = multi
    with torch.no_grad():
        ours = tm.decoder(torch.from_numpy(tok), (gh * 16, gw * 16))
    if multi:
        assert len(ours) == 2
        for a, r in zip(ours, ref):
            _close(a.numpy(), r)
        assert not np.allclose(ours[0].numpy(), ours[1].numpy())
    else:
        assert ours.shape == (b, gh, gw, 6) and ours.dtype == torch.float32
        _close(ours.numpy(), ref)


@pytest.mark.parametrize("backbone,hw", [("vit_tiny_test", (64, 64)),
                                         ("vit_tiny_test", (72, 88)),
                                         (DISTILLED, (96, 80))])
def test_maskformer_network_matches_jax_f32(backbone, hw):
    jm, params, tm = _pair(backbone, "Maskformer")
    x = np.random.default_rng(3).standard_normal((2, *hw, 3)).astype(np.float32)
    jo = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        to = tm(torch.from_numpy(x))
    for k in KEYS:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=k)


def _augreg_npz(path, rng, cfg):
    """A seeded file in the original vision_transformer / AugReg layout."""
    d, h, gs = cfg.embed_dim, cfg.num_heads, cfg.base_img_size // cfg.patch_size
    hd, mlp = d // h, int(d * cfg.mlp_ratio)

    def t(*s):
        return (rng.standard_normal(s) * 0.05).astype(np.float32)

    z = {"embedding/kernel": t(16, 16, 3, d), "embedding/bias": t(d), "cls": t(1, 1, d),
         "Transformer/posembed_input/pos_embedding": t(1, gs * gs + 1, d),
         "Transformer/encoder_norm/scale": 1 + t(d), "Transformer/encoder_norm/bias": t(d)}
    for i in range(cfg.depth):
        b = f"Transformer/encoderblock_{i}/"
        att = b + "MultiHeadDotProductAttention_1/"
        for n in ("query", "key", "value"):
            z[att + f"{n}/kernel"], z[att + f"{n}/bias"] = t(d, h, hd), t(h, hd)
        z[att + "out/kernel"], z[att + "out/bias"] = t(h, hd, d), t(d)
        for k in ("0", "2"):
            z[b + f"LayerNorm_{k}/scale"], z[b + f"LayerNorm_{k}/bias"] = 1 + t(d), t(d)
        z[b + "MlpBlock_3/Dense_0/kernel"], z[b + "MlpBlock_3/Dense_0/bias"] = t(d, mlp), t(mlp)
        z[b + "MlpBlock_3/Dense_1/kernel"], z[b + "MlpBlock_3/Dense_1/bias"] = t(mlp, d), t(d)
    np.savez(path, **z)


def test_augreg_npz_loads_like_jax(tmp_path):
    """The port's reader against the JAX package's: the same file gives
    the same encoder outputs, and the training state's loader puts it
    into student and teacher."""
    path = str(tmp_path / "augreg.npz")
    cfg = BACKBONES["vit_tiny_test"]
    _augreg_npz(path, np.random.default_rng(5), cfg)
    jp = encoder_params_from_augreg_npz(path, cfg.depth)
    sd = state_dict_from_augreg_npz(path, cfg.depth)
    enc = VisionTransformer(cfg, aux_layer=-2)
    enc.load_state_dict(sd, strict=True)
    x = np.random.default_rng(6).standard_normal((2, 64, 80, 3)).astype(np.float32)
    ref = JaxViT(JAX_BACKBONES["vit_tiny_test"], aux_layer=-2).apply({"params": jp},
                                                                     jnp.asarray(x))
    with torch.no_grad():
        ours = enc(torch.from_numpy(x))
    for name, a, b in zip(("cls", "tokens", "aux"), ours, ref):
        _close(a.numpy(), b, what=name)

    tcfg = torch_preset("synthetic", backbone="vit_tiny_test", pretrained_path=path)
    state = load_pretrained_into_state(tcfg, create_train_state(tcfg, "cpu"))
    for model in (state.student, state.teacher):
        own = model.state_dict()
        for k, v in sd.items():
            assert torch.equal(own["encoder." + k], v), k


def _reference_sd(rng, backbone, n_cls=6):
    """A reference-key Maskformer state dict on ``backbone``: the encoder
    (with dist_token when distilled) plus the MaskTransformer's keys."""
    cfg = BACKBONES[backbone]
    d, gs = cfg.embed_dim, cfg.base_img_size // cfg.patch_size
    npre = 2 if cfg.distilled else 1
    model = CoSANetwork(n_cls, backbone, decoder="Maskformer")
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
          for k, v in model.state_dict().items()}
    assert sd["encoder.pos_embed"].shape == (1, gs * gs + npre, d)
    return sd


@pytest.mark.parametrize("backbone", ["vit_tiny_test", DISTILLED])
def test_state_dict_round_trip_maskformer(backbone):
    """reference keys -> the JAX package's tree -> state_dict_from_jax is
    the identity, and the keys load strictly into the port's network."""
    sd = _reference_sd(np.random.default_rng(7), backbone)
    params = network_params_from_torch(dict(sd), depth=BACKBONES[backbone].depth)
    if BACKBONES[backbone].distilled:
        assert "dist_token" in params["encoder"]
    back = state_dict_from_jax(params)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)
    CoSANetwork(6, backbone, decoder="Maskformer").load_state_dict(sd, strict=True)


def test_init_params_of_the_new_parameters():
    """decoder_norm / mask_norm unit and zero (LeCun with fan-in 1 would
    give them a std near 1.14); dist_token and cls_emb truncated N(0, 0.02);
    proj_patch / proj_classes N(0, d_model^-0.5), untruncated; the other
    parameters as before. The optimizer's groups match the JAX package's
    labels for every parameter."""
    m = CoSANetwork(6, DISTILLED, decoder="Maskformer")
    init_params(m, torch.Generator().manual_seed(0))
    p = {n: t.detach() for n, t in m.named_parameters()}
    for name in ("decoder.decoder_norm", "decoder.mask_norm", "decoder.blocks.0.norm1",
                 "encoder.norm"):
        assert torch.equal(p[name + ".weight"], torch.ones_like(p[name + ".weight"])), name
        assert not p[name + ".bias"].any(), name
    for name in ("encoder.dist_token", "encoder.cls_token", "decoder.cls_emb"):
        assert float(p[name].abs().max()) <= 0.04 and float(p[name].std()) > 0.005, name
    d = 64
    for name in ("decoder.proj_patch", "decoder.proj_classes"):
        std = float(p[name].std())
        assert abs(std - d ** -0.5) < 0.1 * d ** -0.5, (name, std)
        assert float(p[name].abs().max()) > 2 * d ** -0.5, name  # not truncated
    assert not p["decoder.proj_dec.bias"].any()
    assert abs(float(p["decoder.proj_dec.weight"].std()) - d ** -0.5) < 0.2 * d ** -0.5

    groups = {n: param_label(n) for n in p}
    assert groups["encoder.dist_token"] == "backbone"
    assert all(g == "decoder" for n, g in groups.items() if n.startswith("decoder."))
    # the JAX tree has one leaf per port parameter: equal label counts
    cfg = jax_preset("synthetic", backbone=DISTILLED, decoder="Maskformer", num_classes=6,
                     mixed_precision=False)
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    flat = jax.tree_util.tree_flatten_with_path(jparams["params"])[0]
    jax_groups = Counter(jax_param_label("/".join(k.key for k in path)) for path, _ in flat)
    assert Counter(groups.values()) == jax_groups
