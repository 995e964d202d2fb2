"""PyTorch port vs the JAX package: the Swin family (models/zoo/swin.py),
its stochastic depth, the mmseg Swin loader and its optimizer groups.

JAX parameter trees at each module's init shapes, drawn from a numpy
seed (:func:`seeded_tree`: nonzero biases, relative-position tables at
std 1 so the index mapping shows), are carried into the port with
``state_dict_from_jax``; the same numpy inputs go through both.

Tolerances: f32 outputs within 1e-5 absolute; f32 gradients within 1e-5
of each tensor's largest magnitude (no less than 1e-7: a gradient that
is zero in exact arithmetic holds rounding noise); bf16 outputs within
2e-2 of the output's largest magnitude (test_torch_step.py's loosest
TOLS entry; both packages round every product to bf16, 2^-8 apart, in
their own order); loaded tensors equal."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.models import build_model as jax_build_model
from cosa_tpu.models.convert import load_pretrained_into_state as jax_load_pretrained
from cosa_tpu.models.zoo import swin as jswin
from cosa_tpu.train.optimizer import param_label as jax_param_label
from cosa_tpu.train.state import TrainState as JaxTrainState
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.models.convert import load_pretrained_into_state, state_dict_from_jax
from cosa_tpu_torch.models.network import build_model, init_params
from cosa_tpu_torch.models.zoo import swin as tswin
from cosa_tpu_torch.train.optimizer import param_label
from cosa_tpu_torch.train.state import create_train_state
from cosa_tpu_torch.train.step import drop_path_generator

RNG = jax.random.PRNGKey(0)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_REL = 2e-2
TINY = tswin.SWIN_CONFIGS["swin_tiny_test"]


def _np(t):
    return jax.tree.map(np.asarray, t)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def seeded_tree(module, *args, seed=0, **kw):
    """``module``'s variables (params, and batch_stats where it has them)
    at its init's shapes, drawn from a numpy seed by leaf kind: conv and
    dense kernels N(0, 1/fan_in), the CAM classifiers N(0, 1/D), norm
    scales 1 + N(0, 0.1^2), running variances U(0.5, 1.5), relative-position
    tables N(0, 1), biases and running means N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("classifier", "aux_classifier"):
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "rel_pos_bias":
            a = rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(a, jnp.float32)

    shapes = jax.eval_shape(lambda: module.init(RNG, *args, **kw))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(ours, ref, dt, what=""):
    ours = ours.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, what
    err = np.abs(ours - ref).max()
    tol = 1e-5 if dt == "f32" else BF16_REL * np.abs(ref).max()
    assert err <= tol, (what, err, tol)


def _pair(jmod, tmod, x, *args):
    """Seeded params for ``jmod`` at ``x``, carried into ``tmod``; returns
    them and ``jmod``'s output on ``x`` (compiled)."""
    params = seeded_tree(jmod, x, *args)["params"]
    tmod.load_state_dict(state_dict_from_jax(params))
    return params, jax.jit(lambda p: jmod.apply({"params": p}, x, *args))(params)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_window_attention_matches_jax(masked, dt):
    jdt, tdt = DTYPES[dt]
    w, heads, c, hp, wp = 4, 2, 16, 8, 8
    mask = jswin._shift_mask(hp, wp, w, 2, 7, 8) if masked else None
    x = _x((2 * (hp // w) * (wp // w), w * w, c))
    jm = jswin.WindowAttention(heads, w, True, jdt)
    tm = tswin.WindowAttention(c, heads, w, True, tdt)
    jmask = None if mask is None else jnp.asarray(mask)
    _, ref = _pair(jm, tm, jnp.asarray(x, jdt), jmask)
    ours = tm(torch.from_numpy(x).to(tdt), None if mask is None else torch.from_numpy(mask))
    assert ours.dtype == tdt
    _close(ours, ref, dt)


# test_zoo_oracle.py:189's sizes (window 4): shifted + padded, shifted,
# unpadded, padded twice, unshifted + padded; and one padded single window
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hh,ww,shift", [(7, 8, 2), (7, 7, 2), (8, 8, 2), (5, 6, 2),
                                         (7, 8, 0), (3, 4, 2)])
def test_swin_block_matches_jax(hh, ww, shift, dt):
    jdt, tdt = DTYPES[dt]
    c, heads, w = 16, 2, 4
    x = _x((2, hh, ww, c))
    jm = jswin.SwinBlock(heads, w, shift, 4, True, 0.0, 1e-5, jdt)
    tm = tswin.SwinBlock(c, heads, w, shift, 4, True, 0.0, 1e-5, tdt)
    _, ref = _pair(jm, tm, jnp.asarray(x, jdt))
    _close(tm(torch.from_numpy(x).to(tdt)), ref, dt)


def test_patch_merging_at_an_odd_size():
    x = _x((2, 7, 9, 5))
    jm, tm = jswin.PatchMerging(1e-5), tswin.PatchMerging(5, 1e-5)
    _, ref = _pair(jm, tm, jnp.asarray(x))
    ours = tm(torch.from_numpy(x))
    assert ours.shape == (2, 4, 5, 10)
    _close(ours, ref, "f32")


DETACHES = ("none", "all", "feat", "cls")
HEADS = ("cls", "cls_aux", "seg", "cam", "cam_aux")


@functools.lru_cache(maxsize=None)
def _jax_network_under_detach():
    """The JAX SwinNetwork's params, input, probe weights, and per detach
    its outputs and the gradients of sum(out[k] * weights[k]) over the five
    heads, all four detaches in one compiled program. The 60 input pads
    stage 0 (15 -> 16) and the last stage (2 -> a single padded window);
    the aux tap is the stage-1 block (-3 of 4)."""
    x = _x((2, 60, 60, 3))
    jm = jswin.SwinNetwork(6, "swin_tiny_test", aux_layer=-3)
    params = seeded_tree(jm, jnp.asarray(x), seed=1)["params"]
    rng = np.random.default_rng(2)
    shapes = jax.eval_shape(lambda: jm.apply({"params": params}, jnp.asarray(x)))
    weights = {k: rng.standard_normal(shapes[k].shape).astype(np.float32) for k in HEADS}

    def loss(p, detach):
        o = jm.apply({"params": p}, jnp.asarray(x), detach=detach)
        return sum((o[k] * weights[k]).sum() for k in HEADS), o

    res = jax.jit(lambda p: {d: jax.grad(loss, has_aux=True)(p, d) for d in DETACHES})(params)
    return params, x, weights, {d: (_np(o), state_dict_from_jax(_np(g)))
                                for d, (g, o) in res.items()}


@pytest.mark.parametrize("detach", DETACHES)
def test_swin_network_matches_jax_under_every_detach(detach):
    """Outputs and the gradients of one scalar of all five heads."""
    params, x, weights, res = _jax_network_under_detach()
    out_j, grads_j = res[detach]
    tm = tswin.SwinNetwork(6, "swin_tiny_test", aux_layer=-3)
    tm.load_state_dict(state_dict_from_jax(_np(params)))
    out_t = tm(torch.from_numpy(x), detach=detach)
    for k in HEADS:
        _close(out_t[k], out_j[k], "f32", k)
    sum((out_t[k] * torch.from_numpy(weights[k])).sum() for k in HEADS).backward()
    for name, p in tm.named_parameters():
        ref = grads_j[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        assert np.abs(got - ref).max() <= max(1e-5 * np.abs(ref).max(), 1e-7), name


# ---------------------------------------------------------------------------
# stochastic depth
# ---------------------------------------------------------------------------


def test_drop_path_keeps_or_drops_each_sample_whole():
    dp = tswin.DropPath(0.5)
    x = torch.ones(64, 3, 5, 4)
    y = dp(x, True, torch.Generator().manual_seed(0)).reshape(64, -1)
    zero, kept = (y == 0).all(dim=1), (y == 2.0).all(dim=1)  # 1 / (1 - 0.5)
    assert bool((zero | kept).all()) and zero.any() and kept.any()
    assert dp(x) is x  # eval: the identity
    assert tswin.DropPath(0.0)(x, True, torch.Generator()) is x


def test_swin_drop_path_follows_seed_and_step():
    """At rate 0.5: the same (seed, step) draws the same masks bitwise,
    another seed or step other masks; eval mode is deterministic."""
    cfg = dataclasses.replace(TINY, drop_path_rate=0.5)
    net = tswin.SwinBackbone(cfg)
    init_params(net, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((2, 64, 64, 3)))

    def run(seed, step):
        return net(x, True, drop_path_generator(seed, step, "cpu"))[0][-1]

    a = run(0, 3)
    assert torch.equal(a, run(0, 3))
    assert not torch.allclose(a, run(1, 3))
    assert not torch.allclose(a, run(0, 4))
    det = net(x)[0][-1]
    assert torch.equal(det, net(x)[0][-1])
    assert not torch.allclose(det, a)


# ---------------------------------------------------------------------------
# the mmseg loader, optimizer groups, init
# ---------------------------------------------------------------------------


def _mmseg_file(params, depths):
    """An mmseg/mmcv Swin state dict (``backbone.`` keys, torch layouts)
    from a JAX SwinBackbone tree with all four stage norms, plus the keys
    an mmseg file also holds: each block's relative_position_index and a
    decode head."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    sd = {"backbone.patch_embed.projection.weight":
          t(np.asarray(params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)),
          "backbone.patch_embed.projection.bias": t(params["patch_embed"]["bias"]),
          "backbone.patch_embed.norm.weight": t(params["patch_norm"]["scale"]),
          "backbone.patch_embed.norm.bias": t(params["patch_norm"]["bias"]),
          "decode_head.conv_seg.weight": torch.zeros(6, 8, 1, 1)}

    def lin(key, p):
        sd[key + ".weight"] = t(np.asarray(p["kernel"]).T)
        if "bias" in p:
            sd[key + ".bias"] = t(p["bias"])

    def ln(key, p):
        sd[key + ".weight"], sd[key + ".bias"] = t(p["scale"]), t(p["bias"])

    for si, depth in enumerate(depths):
        for bi in range(depth):
            p, b = params[f"stage{si}_block{bi}"], f"backbone.stages.{si}.blocks.{bi}."
            ln(b + "norm1", p["norm1"])
            ln(b + "norm2", p["norm2"])
            lin(b + "attn.w_msa.qkv", p["attn"]["qkv"])
            lin(b + "attn.w_msa.proj", p["attn"]["proj"])
            sd[b + "attn.w_msa.relative_position_bias_table"] = t(p["attn"]["rel_pos_bias"])
            sd[b + "attn.w_msa.relative_position_index"] = torch.zeros(16, 16)
            lin(b + "ffn.layers.0.0", p["fc1"])
            lin(b + "ffn.layers.1", p["fc2"])
        if f"merge{si}" in params:
            ln(f"backbone.stages.{si}.downsample.norm", params[f"merge{si}"]["norm"])
            lin(f"backbone.stages.{si}.downsample.reduction", params[f"merge{si}"]["reduction"])
        ln(f"backbone.norm{si}", params[f"norm{si}"])
    return sd


def test_mmseg_swin_file_loads_like_jax(tmp_path):
    x = jnp.asarray(_x((1, 64, 64, 3)))
    src = seeded_tree(jswin.SwinBackbone(jswin.SWIN_CONFIGS["swin_tiny_test"]), x,
                      seed=3)["params"]
    sd = _mmseg_file(src, TINY.depths)
    path = str(tmp_path / "swin.pth")
    torch.save(sd, path)
    kw = dict(model="swinend2end", backbone="swin_tiny_test", mixed_precision=False,
              pretrained_path=path, batch_size=1, crop_size=64)
    cfg_j, cfg_t = jax_preset("synthetic", **kw), torch_preset("synthetic", **kw)
    # the JAX state's student and teacher trees (zeros: only their structure
    # and the file's overlay matter here)
    tree = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(
        jax_build_model(cfg_j).init, RNG, x)["params"])
    state_j = jax_load_pretrained(cfg_j, JaxTrainState(
        step=jnp.zeros((), jnp.int32), student=tree, teacher=tree, opt_state=None, gmm=None))
    state_t = load_pretrained_into_state(cfg_t, create_train_state(cfg_t, "cpu"))

    ref = state_dict_from_jax(_np(state_j.student))
    for model in (state_t.student, state_t.teacher):
        own = model.state_dict()
        for k, v in own.items():
            if k.startswith("backbone."):
                assert torch.equal(v, ref[k]), k
    # the file's norm0-norm2 are not the network's (it builds norm3): dropped
    assert all(f"backbone.norm{i}.weight" in sd for i in range(4))
    assert not any(k.startswith(("backbone.norm0", "backbone.norm1", "backbone.norm2"))
                   for k in state_t.student.state_dict())
    # forward: the loaded backbones agree
    jb = jswin.SwinBackbone(jswin.SWIN_CONFIGS["swin_tiny_test"], (3,))
    out_j = jax.jit(jb.apply)({"params": state_j.student["backbone"]}, x)[0][-1]
    out_t = state_t.student.backbone(torch.from_numpy(np.array(x)))[0][-1]
    _close(out_t, out_j, "f32")

    del sd["backbone.stages.1.blocks.0.attn.w_msa.qkv.weight"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="stage1_block0.attn.qkv.weight"):
        load_pretrained_into_state(cfg_t, create_train_state(cfg_t, "cpu"))


def _jax_leaf_key(path):
    """The port's state-dict key of a JAX SwinNetwork leaf."""
    names = [p.key for p in path]
    leaf = {"kernel": "weight", "scale": "weight"}.get(names[-1], names[-1])
    if names[-1] in ("classifier", "aux_classifier"):
        leaf = "weight"
        names.append(leaf)
    return ".".join(names[:-1] + [leaf])


@pytest.mark.parametrize("freeze_norm", [False, True])
def test_swin_optimizer_groups_match_jax_labels(freeze_norm):
    """Each parameter's group is the JAX package's label of its leaf: the
    norms and the relative-position tables in ``norm`` (out of the
    optimizer with ``freeze_norm``), the rest of the backbone in
    ``backbone``, the classifiers in ``head``, LargeFOV in ``decoder``."""
    kw = dict(model="swinend2end", backbone="swin_tiny_test", num_classes=6,
              freeze_norm=freeze_norm, crop_size=64)
    cfg = torch_preset("synthetic", **kw)
    state = create_train_state(cfg, "cpu")
    jparams = jax.eval_shape(jax_build_model(jax_preset("synthetic", **kw)).init,
                             RNG, jnp.zeros((1, 64, 64, 3)))["params"]
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jax_labels = {_jax_leaf_key(path): jax_param_label("/".join(p.key for p in path))
                  for path, _ in flat}
    names = dict(state.student.named_parameters())
    assert set(jax_labels) == set(names)
    grouped = {id(p): g["name"] for g in state.optimizer.opt.param_groups for p in g["params"]}
    for name, p in names.items():
        label = jax_labels[name]
        assert param_label(name) == label, name
        if label == "norm" and freeze_norm:
            assert id(p) not in grouped and not p.requires_grad, name
        else:
            assert grouped[id(p)] == label, name
    assert jax_labels["backbone.stage0_block0.attn.rel_pos_bias"] == "norm"


def test_init_params_of_the_swin_parameters():
    """rel_pos_bias truncated N(0, 0.02); LayerNorms unit and zero; dense
    and conv weights LeCun-normal (truncated at 2 std), biases zero."""
    cfg = torch_preset("synthetic", model="swinend2end", backbone="swin-t", num_classes=21)
    p = dict(build_model(cfg, "cpu").named_parameters())
    t = torch.cat([v.detach().reshape(-1) for k, v in p.items() if k.endswith("rel_pos_bias")])
    assert float(t.abs().max()) <= 0.04 and abs(float(t.std()) - 0.0176) < 0.002
    for name in ("backbone.patch_norm", "backbone.stage2_block5.norm1", "backbone.merge1.norm",
                 "backbone.norm3"):
        assert torch.equal(p[name + ".weight"], torch.ones_like(p[name + ".weight"])), name
        assert not p[name + ".bias"].any(), name
    for name, fan_in in (("backbone.stage2_block0.attn.qkv.weight", 384),
                         ("backbone.merge2.reduction.weight", 4 * 384),
                         ("backbone.patch_embed.weight", 3 * 16), ("classifier.weight", 768)):
        w = p[name].detach()
        std = fan_in ** -0.5
        assert float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6, name
        assert abs(float(w.std()) - std) < 0.1 * std, name
    assert not p["backbone.stage2_block0.attn.qkv.bias"].any()
