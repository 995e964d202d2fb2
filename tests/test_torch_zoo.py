"""PyTorch port vs the JAX package: the seg-only zoo families
(models/zoo/{mit,resnet,resnet38,deeplab,mmseg}.py), their pools and
BatchNorm, the NVlabs MiT loader, the dispatch and the seg-only guard.

Each family of tests/test_zoo.py's table (plus the VGG16 V1 and MSC) runs
in eval mode and in train mode, with every dropout and drop-path rate at 0
on both sides (the JAX package's nn.Dropout is the identity under
monkeypatch; the port's Dropout/DropPath modules get p = 0). JAX variable
trees at each model's init shapes, drawn from a numpy seed
(test_torch_swin.py's ``seeded_tree``: random running statistics too), are
carried into the port with ``state_dict_from_jax``, params and
``batch_stats``; the same numpy input goes through both.

Tolerances: f32 eval-mode outputs within 1e-5 absolute; the updated
running mean and variance within 1e-5 absolute; train-mode outputs within
1e-3 of the output's largest magnitude: both packages take flax's variance
E[x^2] - E[x]^2 of the batch, which cancels where a channel's mean is
large against its spread (the image-pool branches normalize 2 values), so
f32 sums in another order move the normalized values by far more than
their rounding; pools exact; loaded tensors equal."""

import flax.linen as flax_nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cosa_tpu.models.zoo as J
from cosa_tpu.config import preset_config as jax_preset
from cosa_tpu.models.convert import load_pretrained_into_state as jax_load_pretrained
from cosa_tpu.models.zoo.mit import SRAttention as JaxSRAttention
from cosa_tpu.models.zoo.mmseg import adaptive_avg_pool as jax_adaptive_avg_pool
from cosa_tpu.models.zoo.resnet import max_pool_ceil as jax_pool_ceil
from cosa_tpu.models.zoo.resnet import max_pool_floor as jax_pool_floor
from cosa_tpu.train.state import TrainState as JaxTrainState
import cosa_tpu_torch.models.zoo as T
from cosa_tpu_torch.config import preset_config as torch_preset
from cosa_tpu_torch.eval.engine import evaluate
from cosa_tpu_torch.eval.pseudo_pipeline import generate_pseudo_labels
from cosa_tpu_torch.eval.submit import dump_submission
from cosa_tpu_torch.models.convert import load_pretrained_into_state, state_dict_from_jax
from cosa_tpu_torch.models.network import build_model, init_params
from cosa_tpu_torch.models.zoo.mit import SRAttention
from cosa_tpu_torch.models.zoo.mmseg import adaptive_avg_pool
from cosa_tpu_torch.models.zoo.resnet import BatchNorm, Dropout, max_pool_ceil, max_pool_floor
from cosa_tpu_torch.models.zoo.swin import DropPath
from cosa_tpu_torch.train.loop import train as torch_train
from test_torch_swin import seeded_tree

RNG = jax.random.PRNGKey(0)
X = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
TRAIN_REL = 1e-3

# id: (constructor on the JAX or the port zoo module, apply kwargs, output grid)
FAMILIES = {
    "segformer": (lambda z: z.SegFormer(7, "mit_tiny_test"), {}, 16),
    "wrn38seg": (lambda z: z.WRN38Seg(7, width_div=32), {}, 8),
    "dlv1": (lambda z: z.DeepLabV1(7, n_blocks=(1, 1, 1, 1)), {}, 9),
    "dlv1fov": (lambda z: z.DeepLabV1LargeFOV(7, n_blocks=(1, 1, 1, 1)), {}, 9),
    "dlv2": (lambda z: z.DeepLabV2(7, n_blocks=(1, 1, 1, 1)), {}, 9),
    "dlv3": (lambda z: z.DeepLabV3(7, n_blocks=(1, 1, 1, 1)), {}, 5),
    "dlv3p": (lambda z: z.DeepLabV3Plus(7, n_blocks=(1, 1, 1, 1)), {}, 64),
    "vggv1": (lambda z: z.DeepLabV1VGG16(7), {}, 8),
    "vggv2": (lambda z: z.DeepLabV2VGG16(7), {}, 8),
    "beco": (lambda z: z.BECODeepLabV3Plus(7, depth=26), {}, 16),
    "mmseg-dl3": (lambda z: z.MMSegDeepLab3(7, depth=26), {"aux": True}, 8),
    "mmseg-dl3p": (lambda z: z.MMSegDeepLab3(7, depth=26, separable=True), {"aux": True}, 16),
    "uper-swin": (lambda z: z.UPerSwin(7, "swin_tiny_test"), {"aux": True}, 16),
    "msc": (lambda z: z.MSC(z.DeepLabV2(7, n_blocks=(1, 1, 1, 1)), scales=(0.5,)), {}, 9),
}


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out.detach().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)]


def _rates_off(model, monkeypatch):
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    for m in model.modules():
        if isinstance(m, (Dropout, DropPath)):
            m.p = 0.0


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_seg_family_matches_jax(name, train, monkeypatch):
    make, kw, grid = FAMILIES[name]
    jm, tm = make(J), make(T)
    variables = seeded_tree(jm, jnp.asarray(X), **kw)
    stats = variables.get("batch_stats")
    tm.load_state_dict(state_dict_from_jax(variables["params"], stats))
    _rates_off(tm, monkeypatch)
    if train:
        out_j, mut = jax.jit(lambda v: jm.apply(v, jnp.asarray(X), train=True,
                                                mutable=["batch_stats"], **kw))(variables)
    else:
        out_j = jax.jit(lambda v: jm.apply(v, jnp.asarray(X), **kw))(variables)
    with torch.no_grad():
        out_t = tm(torch.from_numpy(X), train=train, **kw)
    assert isinstance(out_t, list) == (train and name == "msc")
    refs, ours = _flat(out_j), _flat(out_t)
    assert refs[0].shape == (2, grid, grid, 7)
    assert [r.shape for r in refs] == [o.shape for o in ours]
    for r, o in zip(refs, ours):
        tol = TRAIN_REL * np.abs(r).max() if train else 1e-5
        assert np.abs(o - r).max() <= tol, (np.abs(o - r).max(), tol)
    if stats is None:
        return
    want = state_dict_from_jax({}, mut["batch_stats"] if train else stats)
    own = tm.state_dict()
    moved = False
    for k, v in want.items():
        assert np.abs(own[k].numpy() - v.numpy()).max() <= 1e-5, k
        before = state_dict_from_jax({}, stats)[k]
        moved |= not torch.equal(own[k], before)
    assert moved == train


def test_batchnorm_takes_the_biased_variance_and_flax_decay():
    """One train-mode call: the normalized output by the batch's biased
    variance, running mean/var moved by decay 0.9 (torch's BatchNorm would
    take the unbiased variance, and momentum 1 - decay)."""
    bn = BatchNorm(3, momentum=0.9)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 5, 6, 3)).astype(np.float32))
    y = bn(x, train=True)
    flat = x.reshape(-1, 3).double()
    mean, var = flat.mean(0), flat.var(0, unbiased=False)
    np.testing.assert_allclose(bn.running_mean.numpy(), (0.1 * mean).numpy(), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.9 + 0.1 * var).numpy(), atol=1e-6)
    ref = (x.double() - mean) / torch.sqrt(var + 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), ref.numpy(), atol=1e-5)
    assert torch.equal(bn(x), (x - bn.running_mean) * torch.rsqrt(bn.running_var + 1e-5))


@pytest.mark.parametrize("h,w", [(8, 8), (9, 7), (17, 17), (10, 13)])
@pytest.mark.parametrize("ceil", [True, False])
def test_max_pools_match_jax(h, w, ceil):
    x = np.random.default_rng(0).standard_normal((2, h, w, 3)).astype(np.float32)
    ref = (jax_pool_ceil if ceil else jax_pool_floor)(jnp.asarray(x), 3, 2, 1)
    ours = (max_pool_ceil if ceil else max_pool_floor)(torch.from_numpy(x), 3, 2, 1)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("hw,s", [((7, 5), 1), ((7, 5), 2), ((9, 11), 3),
                                  ((6, 6), 6), ((2, 2), 3), ((5, 4), 6)])
def test_adaptive_avg_pool_matches_jax(hw, s):
    """Including output grids larger than the input (UPerHead's PPM at a
    small last-stage grid)."""
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax_adaptive_avg_pool(jnp.asarray(x), s))
    ours = adaptive_avg_pool(torch.from_numpy(x), s).numpy()
    assert ours.shape == ref.shape == (2, s, s, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


@pytest.mark.parametrize("h,w,sr", [(13, 10, 4), (13, 10, 8), (25, 25, 8), (3, 5, 8)])
def test_sr_attention_pads_like_flax_same(h, w, sr):
    """The spatial-reduction conv on a grid that is not a multiple of sr
    (25 is a 100 input's stage-1 grid; 3 x 5 is smaller than sr): the
    port pads to flax's SAME grid, ceil(n / sr)."""
    x = np.random.default_rng(4).standard_normal((2, h, w, 16)).astype(np.float32)
    jm = JaxSRAttention(2, sr, True, 1e-6)
    tm = SRAttention(16, 2, sr, True, 1e-6)
    params = seeded_tree(jm, jnp.asarray(x))["params"]
    tm.load_state_dict(state_dict_from_jax(params))
    ref = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x)))(params))
    ours = tm(torch.from_numpy(x)).detach().numpy()
    assert np.abs(ours - ref).max() <= 1e-5


def test_segformer_at_a_grid_no_sr_divides():
    """A 100 input: stage grids 25, 13, 7, 4 against sr 8, 4, 2, 1."""
    x = np.random.default_rng(5).standard_normal((1, 100, 100, 3)).astype(np.float32)
    jm, tm = J.SegFormer(5, "mit_tiny_test"), T.SegFormer(5, "mit_tiny_test")
    variables = seeded_tree(jm, jnp.asarray(x))
    tm.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]))
    ref = np.asarray(jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(variables))
    ours = tm(torch.from_numpy(x)).detach().numpy()
    assert ours.shape == ref.shape == (1, 25, 25, 5)
    assert np.abs(ours - ref).max() <= 1e-5


# ---------------------------------------------------------------------------
# the NVlabs MiT loader
# ---------------------------------------------------------------------------


def _nvlabs_file(enc, depths):
    """An official SegFormer (NVlabs) state dict from a JAX
    MixVisionTransformer tree, plus its ImageNet head."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    sd = {"head.weight": torch.zeros(1000, 128), "head.bias": torch.zeros(1000)}

    def conv(key, p):
        sd[key + ".weight"] = t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        sd[key + ".bias"] = t(p["bias"])

    def lin(key, p):
        sd[key + ".weight"], sd[key + ".bias"] = t(np.asarray(p["kernel"]).T), t(p["bias"])

    def ln(key, p):
        sd[key + ".weight"], sd[key + ".bias"] = t(p["scale"]), t(p["bias"])

    for si, depth in enumerate(depths):
        s = si + 1
        conv(f"patch_embed{s}.proj", enc[f"patch_embed{s}"])
        ln(f"patch_embed{s}.norm", enc[f"patch_norm{s}"])
        for bi in range(depth):
            p, b = enc[f"block{s}_{bi}"], f"block{s}.{bi}."
            ln(b + "norm1", p["norm1"])
            ln(b + "norm2", p["norm2"])
            for n in ("q", "kv", "proj"):
                lin(b + "attn." + n, p["attn"][n])
            if "sr" in p["attn"]:
                conv(b + "attn.sr", p["attn"]["sr"])
                ln(b + "attn.norm", p["attn"]["sr_norm"])
            lin(b + "mlp.fc1", p["mlp"]["fc1"])
            conv(b + "mlp.dwconv.dwconv", p["mlp"]["dwconv"])
            lin(b + "mlp.fc2", p["mlp"]["fc2"])
        ln(f"norm{s}", enc[f"norm{s}"])
    return sd


def test_nvlabs_mit_file_loads_like_jax(tmp_path):
    x = jnp.asarray(X[:1])
    src = seeded_tree(J.SegFormer(6, "mit_tiny_test"), x, seed=3)["params"]["encoder"]
    sd = _nvlabs_file(src, T.MIT_CONFIGS["mit_tiny_test"].depths)
    path = str(tmp_path / "mit.pth")
    torch.save(sd, path)
    kw = dict(model="segformer", backbone="mit_tiny_test", num_classes=6,
              mixed_precision=False, pretrained_path=path)
    cfg_j, cfg_t = jax_preset("synthetic", **kw), torch_preset("synthetic", **kw)
    tree = seeded_tree(J.SegFormer(6, "mit_tiny_test"), x, seed=9)["params"]
    state_j = jax_load_pretrained(cfg_j, JaxTrainState(
        step=jnp.zeros((), jnp.int32), student=tree, teacher=tree, opt_state=None, gmm=None))

    class State:  # the loader reads and fills .student and .teacher
        student = build_model(cfg_t, "cpu")
        teacher = build_model(cfg_t, "cpu", seed=1)

    load_pretrained_into_state(cfg_t, State)
    ref = state_dict_from_jax(state_j.student)
    for model in (State.student, State.teacher):
        for k, v in model.state_dict().items():
            if k.startswith("encoder."):
                assert torch.equal(v, ref[k]), k
    jenc = J.MixVisionTransformer(J.MIT_CONFIGS["mit_tiny_test"])
    out_j = jax.jit(jenc.apply)({"params": state_j.student["encoder"]}, x)
    out_t = State.student.encoder(torch.from_numpy(X[:1]))
    for a, b in zip(out_t, out_j):
        assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= 1e-5

    del sd["block2.0.attn.kv.weight"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="block2_0.attn.kv.weight"):
        load_pretrained_into_state(cfg_t, State)


# ---------------------------------------------------------------------------
# wiring: dispatch, the seg-only guard, init
# ---------------------------------------------------------------------------


def test_zoo_factory_dispatch():
    """tests/test_zoo.py:258-276's table, through build_zoo_model and
    build_model (which initializes the zoo model)."""
    for model, backbone, cls in [
        ("res38", "res38", T.WRN38Seg),
        ("res38", "beco_r101", T.BECODeepLabV3Plus),
        ("res38", "l2g_r101", T.DeepLabV1LargeFOV),
        ("res38", "l2g_r101_v2", T.DeepLabV2),
        ("mmseg", "uper-swin-t", T.UPerSwin),
        ("mmseg", "deeplab3", T.MMSegDeepLab3),
        ("mmseg", "deeplab3p", T.MMSegDeepLab3),
        ("swinend2end", "swin-t", T.SwinNetwork),
        ("segformer", "mit_b0", T.SegFormer),
    ]:
        cfg = torch_preset("synthetic", model=model, backbone=backbone)
        assert isinstance(T.build_zoo_model(cfg), cls), (model, backbone)
    assert isinstance(build_model(torch_preset("synthetic", model="segformer",
                                               backbone="mit_b0"), "cpu"), T.SegFormer)
    with pytest.raises(NotImplementedError):
        T.build_zoo_model(torch_preset("synthetic", model="res38", backbone="nope"))


def test_zoo_exports_every_jax_name():
    assert sorted(T.__all__) == sorted(J.__all__)
    assert all(hasattr(T, n) for n in T.__all__)


@pytest.mark.parametrize("model,backbone", [("segformer", "mit_tiny_test"),
                                            ("res38", "res38"), ("mmseg", "deeplab3")])
def test_seg_only_models_rejected_at_pipeline_entry(model, backbone, tmp_path):
    cfg = torch_preset("synthetic", model=model, backbone=backbone, work_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="seg-only"):
        torch_train(cfg, max_steps=1, device="cpu")
    with pytest.raises(NotImplementedError, match="seg-only"):
        evaluate(cfg, None, None, device="cpu")
    with pytest.raises(NotImplementedError, match="seg-only"):
        generate_pseudo_labels(cfg, None, None, str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError, match="seg-only"):
        dump_submission(cfg, None, None, str(tmp_path), device="cpu")


def test_init_params_of_the_batchnorm_families():
    """BatchNorm scale 1, bias 0, running mean 0 and variance 1; convs
    LeCun-normal (fan-in in x kh x kw / groups), truncated at 2 std;
    conv biases 0."""
    m = T.MMSegDeepLab3(7, depth=26, separable=True)
    init_params(m, torch.Generator().manual_seed(0))
    bns = [mod for mod in m.modules() if isinstance(mod, BatchNorm)]
    assert len(bns) > 20
    for bn in bns:
        assert torch.equal(bn.weight, torch.ones_like(bn.weight))
        assert not bn.bias.any() and not bn.running_mean.any()
        assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    p = dict(m.named_parameters())
    for name, fan_in in (("backbone.layer2_block1.conv2.conv.weight", 128 * 9),
                         ("decode_head.sep_aspp1.depthwise.conv.weight", 9),
                         ("decode_head.conv_seg.weight", 512)):
        w, std = p[name].detach(), fan_in ** -0.5
        assert float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6, name
        assert abs(float(w.std()) - std) < 0.1 * std, name
    assert not p["decode_head.conv_seg.bias"].any()
